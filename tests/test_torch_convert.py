"""The converters of the port (das_tpu_torch/convert/: dump.py,
atomese2metta.py, chunked.py, precomputed.py, flybase.py) against the JAX
package's (das_tpu, host code only): on the same synthetic input every
converter writes the same bytes, through its functions and through its
`main`; `parse_multiprocess` equals the serial parse; `chunked`'s import
chain (the forkserver preload) loads no torch; and the port's own
`write_canonical` writes a canonical file that both packages' canonical
loaders read back into the store's handles."""

import glob
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from das_tpu.convert import atomese2metta as jx_a2m
from das_tpu.convert import chunked as jx_chunked
from das_tpu.convert import dump as jx_dump
from das_tpu.convert import flybase as jx_flybase
from das_tpu.convert import precomputed as jx_precomputed
from das_tpu.ingest import canonical as jx_canonical
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.convert import atomese2metta, chunked, dump, flybase, precomputed
from das_tpu_torch.ingest import native
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.storage.atom_table import load_metta_file, load_metta_text

ROOT = Path(__file__).resolve().parents[1]
ANIMALS = ROOT / "data" / "samples" / "animals.metta"

NESTED_METTA = """(: Concept Type)
(: Predicate Type)
(: Evaluation Type)
(: List Type)
(: Similarity Type)
(: "human" Concept)
(: "monkey" Concept)
(: "chimp" Concept)
(: "likes" Predicate)
(Similarity "human" "monkey")
(Evaluation "likes" (List "human" "monkey" "chimp"))
(Evaluation "likes" (Evaluation "likes" (List "chimp")))
(List "human" "monkey" "chimp" "human")
"""

SCM = "\n".join(
    ['(ConceptNode "n%d")' % i if i % 3 else
     '(InheritanceLink\n  (ConceptNode "a%d")\n  (ConceptNode "b (tricky)")\n)' % i
     for i in range(60)]
    + ["; a comment (with parens",
       '(EvaluationLink (stv 0.5 0.5) (PredicateNode "p;q") (ListLink (ConceptNode "x") '
       '(ConceptNode "y")))',
       '(MemberLink (GeneNode "G1") (ConceptNode "multi\nline"))'])

SQL_DUMP = textwrap.dedent("""\
    CREATE TABLE public.gene (
        gene_id integer,
        uniquename character varying(255),
        symbol character varying(255)
    );
    CREATE TABLE public.organism (
        organism_id integer,
        genus character varying(255)
    );
    CREATE TABLE public.nokey (
        a integer
    );
    CREATE TABLE public.feature (
        feature_id integer,
        gene_id integer,
        "order" integer,
        name text
    );
    ALTER TABLE ONLY public.gene
        ADD CONSTRAINT gene_pkey PRIMARY KEY (gene_id);
    ALTER TABLE ONLY public.organism
        ADD CONSTRAINT organism_pkey PRIMARY KEY (organism_id);
    ALTER TABLE ONLY public.feature
        ADD CONSTRAINT feature_pkey PRIMARY KEY (feature_id);
    ALTER TABLE ONLY public.feature
        ADD CONSTRAINT feature_gene_fkey FOREIGN KEY (gene_id) REFERENCES public.gene(gene_id);
    COPY public.gene (gene_id, uniquename, symbol) FROM stdin;
    1\tFBgn0000001\tw
    2\tFBgn0000002\tcn
    3\tFBgn0000003\tvg
    4\tFBgn0000004\t\\N
    5\tFBgn0000005\tdpp
    \\.
    COPY public.organism (organism_id, genus) FROM stdin;
    1\tDrosophila
    2\tHomo
    \\.
    COPY public.nokey (a) FROM stdin;
    7
    \\.
    COPY public.feature (feature_id, gene_id, "order", name) FROM stdin;
    10\t1\t3\tw-RA
    11\t2\t1\tcn RB
    12\t5\t\\N\tdpp "RC"
    \\.
""")

REPORT_TSV = textwrap.dedent("""\
    ## FlyBase report
    #gene_fbid\tgene_symbol
    #-----------------------
    FLYBASE:FBgn0000001\tw
    FLYBASE:FBgn0000002\tcn
    FLYBASE:FBgn0000003\tvg
    FLYBASE:FBgn0000005\tdpp
""")


def _files(d):
    return {os.path.relpath(p, d): Path(p).read_bytes()
            for p in sorted(glob.glob(os.path.join(d, "**", "*"), recursive=True))
            if os.path.isfile(p)}



@pytest.fixture(scope="module", autouse=True)
def _scanner():
    """The scanner's library, built once per fresh checkout (a few seconds,
    in this fixture's setup rather than in a test's call)."""
    native.build()

# -- dump.py -------------------------------------------------------------------------


def _stores():
    bio, _, _ = build_bio_atomspace(n_genes=40, n_processes=8, members_per_gene=3,
                                    n_interactions=30, n_evaluations=10, seed=2)
    return {"animals": (load_metta_file(str(ANIMALS)), jx_load(ANIMALS.read_text())),
            "nested": (load_metta_text(NESTED_METTA), jx_load(NESTED_METTA)),
            "bio": (bio, None)}


@pytest.mark.parametrize("name", ["animals", "nested", "bio"])
def test_dump_store_byte_equal(tmp_path, name):
    mine, theirs = _stores()[name]
    if theirs is None:  # das_tpu's builder, same seed
        from das_tpu.models.bio import build_bio_atomspace as jx_build

        theirs, _, _ = jx_build(n_genes=40, n_processes=8, members_per_gene=3,
                                n_interactions=30, n_evaluations=10, seed=2)
    (tmp_path / "pt").mkdir()
    (tmp_path / "jx").mkdir()
    pt = dump.dump_store(mine, str(tmp_path / "pt" / "kb"), include_empty=True)
    jx = jx_dump.dump_store(theirs, str(tmp_path / "jx" / "kb"), include_empty=True)
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p) for p in jx]
    assert _files(tmp_path / "pt") == _files(tmp_path / "jx")
    assert (dump.dump_to_metta(str(tmp_path / "pt" / "kb"))
            == jx_dump.dump_to_metta(str(tmp_path / "jx" / "kb")))
    back, jback = dump.load_dump(str(tmp_path / "pt" / "kb")), jx_dump.load_dump(
        str(tmp_path / "jx" / "kb"))
    assert list(back.nodes) == list(jback.nodes) and list(back.links) == list(jback.links)
    with pytest.raises(FileNotFoundError):
        dump.load_dump(str(tmp_path / "missing"))


@pytest.mark.parametrize("name", ["animals", "bio"])
def test_write_canonical_round_trip(tmp_path, name):
    data = _stores()[name][0]
    path = str(tmp_path / "kb.metta")
    n = dump.write_canonical(data, path)
    assert n == sum(rec.is_toplevel for rec in data.links.values())
    for loaded in (jx_canonical.load_canonical_file(path),
                   native.load_canonical_files_columnar([path])):
        assert set(loaded.nodes) == set(data.nodes) and set(loaded.links) == set(data.links)
        assert ({h: r.is_toplevel for h, r in loaded.links.items()}
                == {h: r.is_toplevel for h, r in data.links.items()})


def test_write_canonical_refuses_what_it_cannot_hold(tmp_path):
    symbol_element = load_metta_text('(: Concept Type)\n(: Similarity Type)\n(: Foo Type)\n'
                                     '(: "a" Concept)\n'
                                     '(Similarity "a" Foo)\n')
    with pytest.raises(ValueError, match="bare symbol"):
        dump.write_canonical(symbol_element, str(tmp_path / "x.metta"))


# -- atomese2metta.py and chunked.py --------------------------------------------------


@pytest.mark.parametrize("processes", [1, 2])
def test_atomese2metta_byte_equal(tmp_path, processes):
    assert atomese2metta.translate_text(SCM, processes=processes) == jx_a2m.translate_text(SCM)
    scm = tmp_path / "in.scm"
    scm.write_text(SCM)
    assert atomese2metta.main([str(scm), str(tmp_path / "pt.metta")]) == 0
    assert jx_a2m.main([str(scm), str(tmp_path / "jx.metta")]) == 0
    assert (tmp_path / "pt.metta").read_bytes() == (tmp_path / "jx.metta").read_bytes()
    with pytest.raises(Exception) as want:
        jx_a2m.translate_text("(ConceptNode")
    with pytest.raises(Exception) as got:
        atomese2metta.translate_text("(ConceptNode")
    assert (type(got.value).__name__, str(got.value)) == (type(want.value).__name__,
                                                          str(want.value))


def test_chunked_equals_das_tpu_and_serial():
    for k in (1, 7, 1000):
        assert list(chunked.split_balanced(SCM, chunk_exprs=k)) == list(
            jx_chunked.split_balanced(SCM, chunk_exprs=k))
    serial = atomese2metta.parse_sexpr(SCM)
    assert serial == jx_a2m.parse_sexpr(SCM)
    assert chunked.parse_multiprocess(SCM, processes=2, chunk_exprs=9) == serial
    assert [chunked.paren_delta(x) for x in SCM.split("\n")] == [
        jx_chunked.paren_delta(x) for x in SCM.split("\n")]
    with pytest.raises(ValueError):
        list(chunked.split_balanced("(a (b)", chunk_exprs=1))


def test_chunked_import_chain_loads_no_torch():
    """The forkserver preloads das_tpu_torch.convert.chunked: its import
    chain, and the worker's parse, stay free of torch (so of CUDA)."""
    code = ("import sys; import das_tpu_torch.convert.chunked as c; "
            "c.parse_sexpr_trees('(A (B \"x\"))'); "
            "print('torch' in sys.modules, 'numpy' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False", "False"]


# -- precomputed.py and flybase.py -------------------------------------------------


def _release(root):
    root.mkdir()
    (root / "dump.sql").write_text(SQL_DUMP)
    pre = root / "precomputed"
    pre.mkdir()
    (pre / "genes_report.tsv").write_text(REPORT_TSV)
    return str(root / "dump.sql"), str(pre)


def test_precomputed_equals_das_tpu(tmp_path):
    for mod, name in ((precomputed, "pt"), (jx_precomputed, "jx")):
        sql, pre = _release(tmp_path / name)
        tables = mod.PrecomputedTables(pre)
        conv = (flybase if mod is precomputed else jx_flybase).FlybaseConverter(
            sql, str(tmp_path / name / "out"), precomputed_dir=pre)
        conv.discover_relevant_tables()
        assert sorted(conv.tables) == ["gene"]
        tables = conv.precomputed
        tables.save_mapping()
        assert mod.normalize_value(" FLYBASE:FBgn0012345 ") == "FBgn0012345"
    assert (tmp_path / "pt/precomputed/mapping.txt").read_bytes() == (
        tmp_path / "jx/precomputed/mapping.txt").read_bytes()
    assert (precomputed.PrecomputedTables(str(tmp_path / "pt/precomputed")).mappings_str()
            == jx_precomputed.PrecomputedTables(str(tmp_path / "jx/precomputed")).mappings_str())


@pytest.mark.parametrize("mode", ["allowlist", "precomputed", "main"])
def test_flybase_byte_equal(tmp_path, mode, capsys):
    outs = {}
    for mod, name in ((flybase, "pt"), (jx_flybase, "jx")):
        sql, pre = _release(tmp_path / name)
        out = str(tmp_path / name / "out")
        if mode == "allowlist":
            stats = mod.FlybaseConverter(sql, out, ["gene", "feature", "nokey"],
                                         chunk_size=4).run()
        elif mode == "precomputed":
            stats = mod.FlybaseConverter(sql, out, precomputed_dir=pre).run()
        else:
            assert mod.main([sql, out, "--tables", "gene", "feature", "--chunk-size", "3"]) == 0
            stats = capsys.readouterr().out
        outs[name] = (stats, _files(out))
    assert outs["pt"] == outs["jx"]
    assert outs["pt"][1]
