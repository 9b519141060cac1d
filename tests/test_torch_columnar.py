"""The columnar store of the port (das_tpu_torch/storage/columnar.py, the
native scanner's columnar route, `write_bio_canonical`) against the JAX
package's (das_tpu, on the CPU) and against the port's own dict path.

das_tpu's columnar store is built from the very columns the port's scanner
produced (its `ColumnarCore` over copies of them), so both packages'
`columnar_finalize` and `TensorDB` upload run on the same input with no
second native build.  Checked: the Finalized arrays bit for bit (das_tpu's
columnar finalize and the port's dict finalize), the lazy views' dict
semantics, the facade's columnar route with answers held to das_tpu's
"memory" backend, device tables bit-equal to das_tpu's through a commit
and a second canonical load onto the columnar store, a snapshot and a
checkpoint of a columnar store, and the bio canonical generator
byte-equal to das_tpu's and equal to the in-process builder."""

import numpy as np
import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.ingest import canonical as jx_canonical
from das_tpu.ingest import native as jx_native
from das_tpu.models.bio import write_bio_canonical as jx_write_bio
from das_tpu.query import ast as jx_ast
from das_tpu.storage import columnar as jx_columnar
from das_tpu.storage.atom_table import AtomSpaceData as JxData
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.ingest import canonical, native
from das_tpu_torch.models.bio import build_bio_atomspace, write_bio_canonical
from das_tpu_torch.query import ast
from das_tpu_torch.storage.columnar import LazyHexRows, LazyLinks, LazyNodes, LazyRowOfHex
from tests.test_torch_ingest import generated_corpus
from tests.test_torch_query import _answer, _build
from tests.test_torch_store import _assert_tables_equal, _jx_tables

BIO = dict(n_genes=60, n_processes=12, members_per_gene=3, n_interactions=80,
           n_evaluations=20, seed=5)

CORE_FIELDS = ("type_names", "type_hash16", "td_name_tid", "td_stype_tid", "td_ct", "td_hash",
               "node_hash", "node_tid", "node_name_off", "node_name_blob", "link_hash",
               "link_tid", "link_ct", "link_top", "link_elem_off", "link_elem", "dangling")

DANGLING = ('(: Concept Type)\n(: "human" Concept)\n'
            '(Similarity "Concept human" (List "Concept monkey"))\n'
            '(Similarity "Concept human" "Concept human")\n')



@pytest.fixture(scope="module", autouse=True)
def _scanner():
    """The scanner's library, built once per fresh checkout (a few seconds,
    in this fixture's setup rather than in a test's call)."""
    native.build()

@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_SNAPSHOT_DIR",
                "DAS_TPU_WAL", "DAS_TPU_CHECKPOINT", "DAS_TPU_COLUMNAR", "DAS_TPU_NO_NATIVE"):
        monkeypatch.delenv(var, raising=False)


def _file(tmp_path, kind):
    path = tmp_path / f"{kind}.metta"
    if kind == "bio":
        write_bio_canonical(str(path), **BIO)
    else:
        path.write_text({"corpus": generated_corpus(60),
                         "dangling": DANGLING}[kind])
    return str(path)


def _jx_columnar(data):
    """das_tpu's columnar store over copies of the port store's columns."""
    core = data.columnar
    fields = {}
    for name in CORE_FIELDS:
        v = getattr(core, name)
        fields[name] = v.copy() if isinstance(v, np.ndarray) else type(v)(v)
    return jx_columnar.attach_columnar(JxData(), jx_columnar.ColumnarCore(**fields))


def assert_finalized_equal(f1, f2):
    assert (f1.atom_count, f1.node_count) == (f2.atom_count, f2.node_count)
    assert list(f1.hex_of_row) == list(f2.hex_of_row)
    assert f1.type_names == f2.type_names and f1.type_id_of_hash == f2.type_id_of_hash
    assert f1.node_type_id.dtype == f2.node_type_id.dtype
    assert np.array_equal(f1.node_type_id, f2.node_type_id)
    assert sorted(f1.buckets) == sorted(f2.buckets)
    for a, b1 in f1.buckets.items():
        b2 = f2.buckets[a]
        for name in ("rows", "type_id", "ctype", "targets", "targets_sorted", "order_by_type",
                     "key_type", "order_by_ctype", "key_ctype"):
            x, y = getattr(b1, name), getattr(b2, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a, name)
        for name in ("order_by_type_pos", "key_type_pos", "order_by_pos", "key_pos",
                     "order_by_type_spos", "key_type_spos"):
            xs, ys = getattr(b1, name), getattr(b2, name)
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert x.dtype == y.dtype and np.array_equal(x, y), (a, name)
    for name in ("incoming_offsets", "incoming_links"):
        x, y = getattr(f1, name), getattr(f2, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert f1.dangling_hexes == f2.dangling_hexes


@pytest.mark.parametrize("kind", ["corpus", "bio", "dangling"])
def test_columnar_finalize_equals_das_tpu_and_dict_path(tmp_path, kind):
    path = _file(tmp_path, kind)
    col = native.load_canonical_files_columnar([path])
    assert col.columnar is not None and isinstance(col.links, LazyLinks)
    fin = col.finalize()
    assert isinstance(fin.hex_of_row, LazyHexRows) and isinstance(fin.row_of_hex, LazyRowOfHex)
    assert_finalized_equal(fin, _jx_columnar(col).finalize())
    assert_finalized_equal(fin, canonical.load_canonical_file(path).finalize())
    assert_finalized_equal(fin, jx_canonical.load_canonical_file(path).finalize())


def test_lazy_view_semantics(tmp_path):
    path = _file(tmp_path, "corpus")
    d1, d2 = canonical.load_canonical_file(path), native.load_canonical_files_columnar([path])
    assert isinstance(d2.nodes, LazyNodes)
    for mine, want in ((d2.nodes, d1.nodes), (d2.links, d1.links)):
        assert len(mine) == len(want)
        assert list(mine) == list(want) and list(mine.keys()) == list(want)
        assert list(reversed(mine)) == list(reversed(list(want)))
        assert [h for h, _ in mine.items()] == list(want)
        assert list(mine.values()) == list(want.values())
        some = next(iter(want))
        assert some in mine and mine.get(some) == want[some] and mine[some] == want[some]
        assert "0" * 32 not in mine and mine.get("0" * 32) is None and "zz" not in mine
        with pytest.raises(KeyError):
            mine["0" * 32]
    # the overlay: a new record shadows nothing and iterates last
    rec = next(iter(d1.links.values()))
    d2.links["f" * 32] = rec
    assert list(d2.links)[-1] == "f" * 32 and next(reversed(d2.links)) == "f" * 32
    assert d2.links["f" * 32] is rec and len(d2.links) == len(d1.links) + 1
    # set_toplevel writes through to the column
    inner = next(h for h, r in d1.links.items() if not r.is_toplevel)
    assert not d2.links[inner].is_toplevel
    d2.links.set_toplevel(inner)
    assert d2.links[inner].is_toplevel
    # the row registries
    fin = native.load_canonical_files_columnar([path]).finalize()
    hexes = list(fin.hex_of_row)
    assert [fin.row_of_hex[h] for h in hexes] == list(range(len(hexes)))
    assert fin.hex_of_row[-1] == hexes[-1] and fin.row_of_hex.get("0" * 32) is None
    fin.hex_of_row.append("e" * 32)
    fin.row_of_hex["e" * 32] = len(hexes)
    assert fin.hex_of_row[len(hexes)] == "e" * 32 and fin.row_of_hex["e" * 32] == len(hexes)
    assert len(fin.hex_of_row) == len(hexes) + 1 and "e" * 32 in fin.row_of_hex


def _bio_queries(data):
    genes = sorted(r.name for r in data.nodes.values() if r.named_type == "Gene")[:6]
    out = []
    for g in genes:
        grounded = [("L", "Member", [("N", "Gene", g), ("V", "V3")], True),
                    ("L", "Member", [("V", "V2"), ("V", "V3")], True)]
        inter = ("L", "Interacts", [("N", "Gene", g), ("V", "V2")], True)
        out.append(("And", grounded + [inter]))
        out.append(("And", grounded + [("Not", inter)]))
    out.append(("Or", [out[0], out[2]]))
    # different variable sets: the staged tree (query/tree.py materialize_tables)
    out.append(("Or", [("L", "Member", [("N", "Gene", genes[0]), ("V", "V3")], True),
                       ("L", "Interacts", [("N", "Gene", genes[1]), ("V", "V2")], True)]))
    return out


def _jx_memory(path):
    return JxDAS(backend="memory", data=jx_canonical.load_canonical_file(path))


def test_facade_columnar_route(tmp_path):
    path = _file(tmp_path, "bio")
    das = DistributedAtomSpace(backend="tensor", device="cpu")
    das.load_canonical_knowledge_base(path)
    assert das.data.columnar is not None
    ref = _jx_memory(path)
    assert das.count_atoms() == ref.count_atoms()
    for spec in _bio_queries(das.data):
        assert _answer(das, _build(ast, spec)) == _answer(ref, _build(jx_ast, spec)), spec
    for names in (False, True):
        assert das.db.get_all_nodes("Gene", names) == ref.db.get_all_nodes("Gene", names)
    gene = das.get_node("Gene", "GENE:0000001")
    assert gene == ref.get_node("Gene", "GENE:0000001")
    assert sorted(das.get_links("Member", targets=[gene, "*"])) == sorted(
        ref.get_links("Member", targets=[gene, "*"]))
    assert sorted(das.db.get_incoming(gene)) == sorted(ref.db.get_incoming(gene))


def _commit(das, lines):
    tx = das.open_transaction()
    for line in lines:
        tx.add(line)
    das.commit_transaction(tx)


COMMIT = ['(: "GENE:new1" Gene)', '(Member "GENE:new1" "GO:0000001")',
          '(Interacts "GENE:0000002" "GENE:new1")', '(Interacts "GENE:new1" "GENE:0000002")']
SECOND = ('(: Gene Type)\n(: BiologicalProcess Type)\n(: Member Type)\n'
          '(: "GENE:second" Gene)\n(: "GO:0000003" BiologicalProcess)\n'
          '(Member "Gene GENE:second" "BiologicalProcess GO:0000003")\n'
          '(Member "Gene GENE:0000004" "BiologicalProcess GO:0000003")\n')


def test_tables_equal_das_tpu_through_commit_and_second_load(tmp_path, monkeypatch):
    """Device tables bit-equal to das_tpu's TensorDB over das_tpu's columnar
    store: after the load, after a commit (incremental, resolving base
    terminals through the store) and after a second canonical load onto
    the now non-empty store (the record stream, then an incremental
    commit).  das_tpu's second load runs its Python canonical loader,
    record-identical to the stream."""
    path = _file(tmp_path, "bio")
    pt = DistributedAtomSpace(backend="tensor", device="cpu")
    pt.load_canonical_knowledge_base(path)
    jx = JxDAS(backend="tensor", data=_jx_columnar(pt.data))
    assert isinstance(jx.db, JxTensorDB)
    # the port's facade was built empty, then loaded: one rebuild more
    offset = pt.db.delta_version - jx.db.delta_version

    def check():
        _assert_tables_equal(_jx_tables(jx.db), pt.db.dev)
        assert list(pt.db.fin.hex_of_row) == list(jx.db.fin.hex_of_row)
        assert pt.db.delta_version - jx.db.delta_version == offset
        assert pt.db._delta_total == jx.db._delta_total
        assert pt.count_atoms() == jx.count_atoms()

    check()
    version = pt.db.delta_version
    for das in (pt, jx):
        _commit(das, COMMIT)
    assert pt.db.delta_version == version + 1 and pt.db._delta_total == 4
    check()
    second = tmp_path / "second.metta"
    second.write_text(SECOND)
    monkeypatch.setattr(jx_native, "native_available", lambda: False)
    pt.load_canonical_knowledge_base(str(second))
    jx.load_canonical_knowledge_base(str(second))
    assert pt.data.columnar is not None and pt.db.delta_version == version + 2
    check()
    ref = _jx_memory(path)
    _commit(ref, COMMIT)
    ref.load_canonical_knowledge_base(str(second))
    for spec in _bio_queries(pt.data)[:4]:
        assert _answer(pt, _build(ast, spec)) == _answer(ref, _build(jx_ast, spec)), spec


def test_snapshot_and_checkpoint_of_columnar_store(tmp_path):
    """A generational snapshot and a flat checkpoint of a freshly loaded
    columnar store restore (as dict stores) with every device table and
    the row registry equal to the live store's; the same commit on the
    live and the restored stores then leaves them equal again."""
    path = _file(tmp_path, "bio")
    das = DistributedAtomSpace(backend="tensor", device="cpu")
    das.load_canonical_knowledge_base(path)
    das.save_snapshot(str(tmp_path / "snap"))
    das.save_checkpoint(str(tmp_path / "ckpt"))
    restored = DistributedAtomSpace(backend="tensor", device="cpu")
    restored.restore_snapshot(str(tmp_path / "snap"))
    loaded = DistributedAtomSpace(backend="tensor", device="cpu")
    loaded.load_checkpoint(str(tmp_path / "ckpt"))
    for other in (restored, loaded):
        assert other.data.columnar is None and other.count_atoms() == das.count_atoms()
        assert list(other.db.fin.hex_of_row) == list(das.db.fin.hex_of_row)
        _assert_same_tables(das, other)
    # restored as dict stores, they resolve a base terminal by name only
    # once declared (as das_tpu's do: the columnar symbol table probes the
    # store instead of listing terminals); a declaration adds no atom
    declared = ['(: "GO:0000001" BiologicalProcess)', '(: "GENE:0000002" Gene)'] + COMMIT
    for d in (das, restored, loaded):
        _commit(d, declared)
    for other in (restored, loaded):
        _assert_same_tables(das, other)
        spec = _bio_queries(das.data)[0]
        assert _answer(other, _build(ast, spec)) == _answer(das, _build(ast, spec))


def _assert_same_tables(a, b):
    """Every device tensor of two port stores equal (dtype, shape, values),
    through tests/test_torch_store.py's comparison."""
    from das_tpu_torch.storage.tensor_db import BUCKET_LIST_PADS, BUCKET_PADS

    dev = a.db.dev
    want = {n: getattr(dev, n).numpy()
            for n in ("node_type_id", "incoming_offsets", "incoming_links")}
    want["buckets"] = {
        arity: {"size": b.size,
                **{n: getattr(b, n).numpy() for n, _ in BUCKET_PADS},
                **{n: [x.numpy() for x in getattr(b, n)] for n, _ in BUCKET_LIST_PADS}}
        for arity, b in dev.buckets.items()}
    _assert_tables_equal(want, b.db.dev)


@pytest.mark.parametrize("skew", [0.0, 1.2])
def test_write_bio_canonical(tmp_path, skew):
    cfg = dict(BIO, skew=skew)
    mine, theirs = tmp_path / "pt.metta", tmp_path / "jx.metta"
    assert write_bio_canonical(str(mine), **cfg) == jx_write_bio(str(theirs), **cfg)
    assert mine.read_bytes() == theirs.read_bytes()
    built, _, _ = build_bio_atomspace(**cfg)
    col = native.load_canonical_files_columnar([str(mine)])
    assert col.count_atoms() == built.count_atoms()
    assert set(col.nodes) == set(built.nodes) and set(col.links) == set(built.links)
    assert_finalized_equal(col.finalize(), built.finalize())
