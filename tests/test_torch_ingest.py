"""Bulk ingest of the port (das_tpu_torch/ingest/: pipeline.py, atomese.py,
canonical.py, native.py) against the JAX package's (das_tpu, on the CPU).

A directory of `.scm` files, and one mixing `.scm` and `.metta`, loads
into device tables equal bit for bit to das_tpu's (the port used to keep
only `.metta` files); the Atomese and canonical parsers give the same
records as das_tpu's on the same text, errors included; the native
scanner's record stream and the Python canonical loader are
record-identical; its md5 equals hashlib's; the Python canonical loader's
store, handed to the facade, never touches the native library and uploads
the same tables as the scanner's; and the library's build reads
native/src/ in place, writes only das_tpu_torch/ingest/build/, and
raises with the compiler's output when it fails (no fallback).  The
JAX side runs only its host parsers and its TensorDB upload: no compiled
query."""

import hashlib
import os
import sys
from pathlib import Path

import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.exceptions import AtomeseLexerError as JxLexErr
from das_tpu.core.exceptions import AtomeseSyntaxError as JxSynErr
from das_tpu.ingest import canonical as jx_canonical
from das_tpu.ingest.atomese import AtomeseParser as JxAtomeseParser
from das_tpu.storage.atom_table import AtomSpaceData as JxData
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.exceptions import AtomeseLexerError, AtomeseSyntaxError
from das_tpu_torch.ingest import canonical, native, pipeline
from das_tpu_torch.ingest.atomese import AtomeseParser
from das_tpu_torch.storage.atom_table import AtomSpaceData
from tests.test_torch_store import _assert_tables_equal, _jx_tables

ROOT = Path(__file__).resolve().parents[1]

SCM = """
; a comment line
(InheritanceLink (ConceptNode "Allen") (ConceptNode "human"))
(SimilarityLink (stv 0.9 0.8) (ConceptNode "Allen") (ConceptNode "Bob"))
(EvaluationLink
    (PredicateNode "likes")
    (ListLink (ConceptNode "Allen") (ConceptNode "Bob")))
"""

SCM_B = """
(InheritanceLink (ConceptNode "Bob") (ConceptNode "human"))
(MemberLink (ConceptNode "Carol") (ConceptNode "human"))
"""

METTA = """(: Concept Type)
(: Similarity Type)
(: "Concept:Allen" Concept)
(: "dog" Concept)
(Similarity "Concept:Allen" "dog")
"""

NESTED = """(: Evaluation Type)
(: Predicate Type)
(: Reactome Type)
(: Concept Type)
(: "Predicate:has_name" Predicate)
(: "Reactome:R-HSA-164843" Reactome)
(: "Concept:2-LTR circle formation" Concept)
(Evaluation "Predicate Predicate:has_name" (Evaluation "Predicate Predicate:has_name" "Reactome Reactome:R-HSA-164843"))
(Evaluation "Predicate Predicate:has_name" "Concept Concept:2-LTR circle formation")
(Evaluation "Predicate Predicate:has_name" "Reactome Reactome:R-HSA-164843")
"""


def generated_corpus(n=120) -> str:
    lines = ["(: Member Type)", "(: Interacts Type)", "(: List Type)", "(: Gene Type)",
             "(: Proc Type)"]
    genes = [f"G{i} alpha" for i in range(n)]
    procs = [f"P{i}" for i in range(30)]
    lines += [f'(: "{g}" Gene)' for g in genes]
    lines += [f'(: "{p}" Proc)' for p in procs]
    for i, g in enumerate(genes):
        p = procs[i % len(procs)]
        lines.append(f'(Member "Gene {g}" "Proc {p}")')
        if i % 3 == 0:
            g2 = genes[(i * 7 + 1) % len(genes)]
            lines.append(f'(Interacts "Gene {g}" (List "Gene {g2}" "Proc {p}"))')
    return "\n".join(lines) + "\n"


def records(data):
    """Every record and symbol-table entry of a store as plain values, in
    insertion order (either package)."""
    return {
        "nodes": [(h, r.name, r.named_type, r.named_type_hash) for h, r in data.nodes.items()],
        "links": [(h, r.named_type, r.named_type_hash, r.composite_type,
                   r.composite_type_hash, tuple(r.elements), r.is_toplevel)
                  for h, r in data.links.items()],
        "typedefs": [(h, r.name, r.name_hash, r.composite_type_hash, r.designator_name)
                     for h, r in data.typedefs.items()],
        "named_type_hash": dict(data.table.named_type_hash),
        "named_types": dict(data.table.named_types),
        "parent_type": dict(data.table.parent_type),
        "symbol_hash": dict(data.table.symbol_hash),
        "terminal_hash": dict(data.table.terminal_hash),
    }


def _write(dir_, name, text):
    p = Path(dir_) / name
    p.write_text(text)
    return str(p)



@pytest.fixture(scope="module", autouse=True)
def _scanner():
    """The scanner's library, built once per fresh checkout (a few seconds,
    in this fixture's setup rather than in a test's call)."""
    native.build()

# -- the .scm repair ---------------------------------------------------------------


@pytest.mark.parametrize("files", [
    {"a.scm": SCM, "b.scm": SCM_B},
    {"a.scm": SCM, "b.metta": METTA, "c.scm": SCM_B, "notes.txt": "ignored"},
], ids=["scm_only", "mixed"])
def test_scm_directory_tables_equal_das_tpu(tmp_path, files):
    for name, text in files.items():
        _write(tmp_path, name, text)
    pt = DistributedAtomSpace(backend="tensor", device="cpu")
    pt.load_knowledge_base(str(tmp_path))
    jx = JxDAS(backend="tensor")
    jx.load_knowledge_base(str(tmp_path))
    assert pt.count_atoms() == jx.count_atoms()
    assert pt.db.fin.hex_of_row == jx.db.fin.hex_of_row
    _assert_tables_equal(_jx_tables(jx.db), pt.db.dev)
    assert records(pt.data) == records(jx.data)
    assert pipeline.knowledge_base_file_list(str(tmp_path)) == jx._get_file_list(str(tmp_path))


def test_file_list_errors(tmp_path):
    for fn in (pipeline.knowledge_base_file_list, jx_canonical_file_list()):
        with pytest.raises(ValueError, match="Invalid knowledge base path"):
            fn(str(tmp_path / "missing"))
        with pytest.raises(ValueError, match="No MeTTa files found"):
            fn(str(tmp_path))


def jx_canonical_file_list():
    from das_tpu.ingest.pipeline import knowledge_base_file_list

    return knowledge_base_file_list


# -- parsers -----------------------------------------------------------------------


def _parse_scm(parser_cls, data, text):
    out = {"typedefs": [], "terminals": [], "regular": []}
    parser = parser_cls(symbol_table=data.table, on_typedef=out["typedefs"].append,
                        on_terminal=out["terminals"].append,
                        on_expression=out["regular"].append, on_toplevel=out["regular"].append)
    assert parser.parse(text) == "SUCCESS"
    return {k: [e.to_dict() if hasattr(e, "to_dict") else vars(e) for e in v]
            for k, v in out.items()}


def test_atomese_parity():
    assert (_parse_scm(AtomeseParser, AtomSpaceData(), SCM + SCM_B)
            == _parse_scm(JxAtomeseParser, JxData(), SCM + SCM_B))
    pt, jx = AtomSpaceData(), JxData()
    assert AtomeseParser(symbol_table=pt.table).check(SCM) == "SUCCESS"
    assert JxAtomeseParser(symbol_table=jx.table).check(SCM) == "SUCCESS"


@pytest.mark.parametrize("bad", ['(ConceptNode "a") $', "(ConceptNode", "(\"x\" y)",
                                 "(ListLink)", '(ConceptNode "a" "b")'])
def test_atomese_errors_equal(bad):
    with pytest.raises((JxLexErr, JxSynErr, IndexError)) as want:
        _parse_scm(JxAtomeseParser, JxData(), bad)
    with pytest.raises((AtomeseLexerError, AtomeseSyntaxError, IndexError)) as got:
        _parse_scm(AtomeseParser, AtomSpaceData(), bad)
    assert (type(got.value).__name__, str(got.value)) == (type(want.value).__name__,
                                                          str(want.value))


@pytest.mark.parametrize("text", [NESTED, generated_corpus()], ids=["nested", "corpus"])
def test_canonical_loader_parity(text):
    assert records(canonical.load_canonical_text(text)) == records(
        jx_canonical.load_canonical_text(text))


def test_native_and_python_loaders_record_identical(tmp_path):
    text = generated_corpus()
    assert records(native.load_canonical_text_native(text)) == records(
        canonical.load_canonical_text(text))
    pa, pb = _write(tmp_path, "a.metta", text), _write(tmp_path, "b.metta", NESTED)
    streamed = native.load_canonical_files_native([pa, pb], n_threads=2)
    py = canonical.CanonicalLoader()
    py.parse_file(pa)
    py.parse_file(pb)
    assert records(streamed) == records(py.data)
    # the columnar scan reconstructs the same records through its views (its
    # symbol table resolves terminals through the store instead of holding
    # an entry per terminal: storage/columnar.py attach_columnar)
    col = records(native.load_canonical_files_columnar([pa, pb], n_threads=2))
    want = records(py.data)
    for key in ("nodes", "links", "typedefs", "named_type_hash", "parent_type", "symbol_hash"):
        assert col[key] == want[key], key


def test_md5_parity():
    for s in [b"", b"a", b"Concept human", b"x" * 55, b"y" * 56, b"z" * 64, b"w" * 1000]:
        assert native.native_md5_hex(s) == hashlib.md5(s).hexdigest()


@pytest.mark.parametrize("bad", [
    '(: A Type)\n(: "A a" A)\n(Member "A a"\n',
    '(: A Type)\n(: "A a" A)\n(Member "A a")\n(: B Type)\n',
    '(Member "A a")\n',
    '(: A Type)\n(: "A a" A)\n(Member "Aa")\n',
], ids=["unbalanced", "typedef_after_expr", "no_typedef", "bad_terminal"])
def test_error_reporting(bad):
    with pytest.raises(jx_canonical.CanonicalFormatError) as want:
        jx_canonical.load_canonical_text(bad)
    with pytest.raises(canonical.CanonicalFormatError) as got:
        canonical.load_canonical_text(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(native.NativeParseError) as nat:
        native.load_canonical_text_native(bad)
    assert isinstance(nat.value, canonical.CanonicalParseError)
    # the same line as the Python loader's report
    assert str(want.value).split(":")[0] in str(nat.value)


# -- the facade's routes -------------------------------------------------------------


def test_python_route_never_touches_native(tmp_path, monkeypatch):
    path = _write(tmp_path, "kb.metta", generated_corpus())

    def no_native():
        raise AssertionError("the Python canonical loader reached the native library")

    monkeypatch.setattr(native, "get_lib", no_native)
    py = DistributedAtomSpace(backend="tensor", device="cpu",
                              data=canonical.load_canonical_file(path))
    assert py.data.columnar is None
    monkeypatch.undo()
    nat = DistributedAtomSpace(backend="tensor", device="cpu")
    nat.load_canonical_knowledge_base(path)
    assert nat.data.columnar is not None
    assert list(py.db.fin.hex_of_row) == list(nat.db.fin.hex_of_row)
    jx = JxDAS(backend="tensor", data=jx_canonical.load_canonical_file(path))
    _assert_tables_equal(_jx_tables(jx.db), py.db.dev)
    _assert_tables_equal(_jx_tables(jx.db), nat.db.dev)


# -- the build -----------------------------------------------------------------------

FAKE_CXX = """#!{python}
import pathlib, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if {fail!r}:
    print("fake compiler: boom")
    sys.exit(1)
pathlib.Path(args[args.index("-o") + 1]).write_bytes(b"not a library")
"""


def _fake_cxx(tmp_path, fail=False):
    log = tmp_path / "cxx.log"
    exe = tmp_path / "fake-g++"
    exe.write_text(FAKE_CXX.format(python=sys.executable, log=str(log), fail=fail))
    exe.chmod(0o755)
    return str(exe), log


def _tree(path):
    return sorted((str(p.relative_to(path)), p.stat().st_size, p.stat().st_mtime_ns)
                  for p in path.rglob("*"))


def test_build_writes_only_its_build_dir(tmp_path, monkeypatch):
    """The real library sits in das_tpu_torch/ingest/build/; a build reads
    native/src/ in place (one compile per source, native/Makefile's flags),
    writes objects and the .so only into the build directory (renamed into
    place), and leaves native/ untouched."""
    so = native.build()
    assert so.parent == ROOT / "das_tpu_torch" / "ingest" / "build"
    assert so.name.startswith("libdas_native_") and so.suffix == ".so"
    native_before = _tree(ROOT / "native")
    cxx, log = _fake_cxx(tmp_path)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    built = native.build()
    assert built.parent == build_dir and built.read_bytes() == b"not a library"
    assert sorted(p.name for p in build_dir.iterdir()) == [".lock", built.name]
    calls = log.read_text().splitlines()
    assert len(calls) == len(native.SOURCES) + 1
    compiled = []
    for call in calls[:-1]:  # the compiles run together, in any order
        argv = call.split()
        assert argv[:6] == list(native.CXX_FLAGS)
        compiled.append(argv[argv.index("-c") + 1])
        assert Path(argv[argv.index("-o") + 1]).parent == build_dir
    assert sorted(compiled) == sorted(str(ROOT / "native" / "src" / s) for s in native.SOURCES)
    assert calls[-1].split()[0] == "-shared"
    assert native.build() == built and len(log.read_text().splitlines()) == len(calls)
    assert _tree(ROOT / "native") == native_before
    # another digest for other flags
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.build() != built


@pytest.mark.parametrize("how", ["compiler_fails", "no_compiler"])
def test_failed_build_raises(tmp_path, monkeypatch, capsys, how):
    """A build that fails, or a missing compiler, makes the load raise with
    the compiler's output; nothing falls back to the Python loader."""
    if how == "compiler_fails":
        cxx, _ = _fake_cxx(tmp_path, fail=True)
    else:
        cxx = str(tmp_path / "no-such-g++")
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    path = _write(tmp_path, "kb.metta", NESTED)
    das = DistributedAtomSpace(backend="tensor", device="cpu")
    with pytest.raises(native.NativeBuildError) as err:
        das.load_canonical_knowledge_base(path)
    expect = "fake compiler: boom" if how == "compiler_fails" else "cannot run"
    assert expect in str(err.value) and expect in capsys.readouterr().err
    assert das.count_atoms() == (0, 0)
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix in (".so", ".o")]
    # the record-stream route (non-empty store) raises the same way
    das.load_metta_text('(: Concept Type)\n(: "a" Concept)\n')
    with pytest.raises(native.NativeBuildError):
        das.load_canonical_knowledge_base(path)
    assert os.path.exists(path)
