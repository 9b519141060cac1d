"""Incremental commits of the port (das_tpu_torch/storage/delta.py and
tensor_db.py, device="cpu") against the JAX package's (das_tpu, JAX on the
CPU): the same transactions through both facades leave device tables that
are equal bit for bit (every posting key and permutation, every padded
column, size and capacity), the same `delta_version`, `_delta_total` and
overlay segments, and the same answers, across the incremental,
accumulated, capacity-growth, new-arity, threshold-rebuild and
dangling-target cases (the tensor-backend cases of
tests/test_incremental.py).  Also: `merge_sorted_index` against the JAX
merge, stage-then-swap atomicity, the result cache across a commit, and a
batch dispatched before a commit."""

import numpy as np
import pytest
import torch

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query import fused as jx_fused
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu.storage.delta import merge_sorted_index as jx_merge
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.schema import WILDCARD
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query import fused
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.delta import merge_sorted_index
from das_tpu_torch.storage.tensor_db import TensorDB
from tests.test_torch_query import _answer, _build
from tests.test_torch_store import _assert_tables_equal, _jx_tables

LION_TIGER = ['(: "lion" Concept)', '(: "tiger" Concept)',
              '(Inheritance "lion" "mammal")', '(Inheritance "tiger" "mammal")',
              '(Similarity "lion" "tiger")', '(Similarity "tiger" "lion")']
BEAR = ['(: "bear" Concept)', '(Inheritance "bear" "mammal")']
LIST3 = ['(: List Type)', '(List "human" "monkey" "chimp")']

V1, V2 = ("V", "V1"), ("V", "V2")


def _inh(a, b):
    return ("L", "Inheritance", [a, b], True)


def _c(name):
    return ("N", "Concept", name)


#: compiled (conjunctive) and host-answered queries over animals
QUERIES = [
    _inh(V1, _c("mammal")),
    ("And", [_inh(V1, _c("mammal")), _inh(V1, V2)]),
    ("And", [_inh(V1, V2), ("Not", _inh(V1, _c("mammal")))]),
    ("And", [("L", "Similarity", [V1, V2], False), _inh(V1, _c("mammal"))]),
    _inh(_c("lion"), V1),
]


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS",
                "DAS_TPU_VMEM_BUDGET", "DAS_TPU_STAR", "DAS_TPU_HOST_COUNT"):
        monkeypatch.delenv(var, raising=False)


def _pair(planner="off", **cfg):
    """A JAX and a port facade over animals with the same config."""
    jx = JxDAS(backend="tensor", data=jx_load(jx_animals()),
               config=JxConfig(use_planner=planner, use_multiway="off", **cfg))
    pt = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                              device="cpu",
                              config=DasConfig(use_planner=planner, use_multiway="off", **cfg))
    return jx, pt


def _commit(das, lines):
    tx = das.open_transaction()
    for line in lines:
        tx.add(line)
    das.commit_transaction(tx)


def _commit_both(pair, lines):
    for das in pair:
        _commit(das, lines)


def _check(pair, queries=QUERIES):
    """Tables bit for bit, commit counters, overlay segments and answers."""
    jx, pt = pair
    _assert_tables_equal(_jx_tables(jx.db), pt.db.dev)
    for name in ("delta_version", "_delta_total"):
        assert getattr(pt.db, name) == getattr(jx.db, name), name
    assert ({a: len(s) for a, s in pt.db._host_delta.items()}
            == {a: len(s) for a, s in jx.db._host_delta.items()})
    assert sorted(pt.db._base_buckets) == sorted(jx.db._base_buckets)
    assert pt.count_atoms() == jx.count_atoms()
    assert pt.db.fin.hex_of_row == jx.db.fin.hex_of_row
    for spec in queries:
        assert _answer(pt, _build(ast, spec)) == _answer(jx, _build(jx_ast, spec)), spec


def _matched(db, link_type, targets):
    return sorted((h, tuple(t)) for h, t in db.get_matched_links(link_type, targets))


@pytest.mark.parametrize("planner", ["off", "auto"])
def test_commit_takes_incremental_path(planner):
    pair = _pair(planner)
    _check(pair)
    _commit_both(pair, LION_TIGER)
    jx, pt = pair
    assert pt.db._delta_total == 6        # 2 nodes + 4 links, no rebuild
    assert pt.count_atoms() == (16, 30)
    assert pt.db.delta_version == 2       # construct, commit
    _check(pair)
    # an answer on the committed atoms, against a fresh store of the data
    fresh = DistributedAtomSpace(backend="tensor", data=pt.data, device="cpu",
                                 config=DasConfig(use_planner=planner, use_multiway="off"))
    for spec in QUERIES:
        assert _answer(pt, _build(ast, spec)) == _answer(fresh, _build(ast, spec))


def test_probes_and_incoming_see_new_atoms():
    jx, pt = pair = _pair()
    _commit_both(pair, LION_TIGER)
    db, jdb = pt.db, jx.db
    lion = db.get_node_handle("Concept", "lion")
    mammal = db.get_node_handle("Concept", "mammal")
    assert db.link_exists("Inheritance", [lion, mammal])
    matches = _matched(db, "Inheritance", [WILDCARD, mammal])
    assert len(matches) == 6 and matches == _matched(jdb, "Inheritance", [WILDCARD, mammal])
    tmpl = db.get_matched_type_template(["Inheritance", "Concept", "Concept"])
    assert len(tmpl) == 14
    assert sorted(tmpl) == sorted(
        (h, tuple(t)) for h, t in jdb.get_matched_type_template(
            ["Inheritance", "Concept", "Concept"]))
    assert len(db.get_matched_type("Similarity")) == 16
    # the incoming set: base CSR plus the delta overlay, never a re-finalize
    finalize = pt.data.finalize
    pt.data.finalize = None
    try:
        incoming = db.get_incoming(lion)
    finally:
        pt.data.finalize = finalize
    assert len(incoming) == 3 and sorted(incoming) == sorted(jdb.get_incoming(lion))
    human = db.get_node_handle("Concept", "human")
    assert sorted(db.get_incoming(human)) == sorted(jdb.get_incoming(human))
    _check(pair)


def test_accumulated_commits():
    pair = _pair()
    _commit_both(pair, LION_TIGER)
    _commit_both(pair, BEAR)
    jx, pt = pair
    assert pt.db._delta_total == 8 and len(pt.db._host_delta[2]) == 2
    _check(pair, QUERIES + [_inh(_c("bear"), V1)])


def test_threshold_forces_rebuild():
    pair = _pair(delta_merge_threshold=4)
    _commit_both(pair, LION_TIGER)      # 6 atoms > 4: a full rebuild
    jx, pt = pair
    assert pt.db._delta_total == 0 and not pt.db._host_delta
    assert pt.db.delta_version == 2
    _check(pair)


def test_new_arity_bucket():
    pair = _pair()
    _commit_both(pair, LIST3)
    jx, pt = pair
    assert 3 in pt.db._base_buckets and 3 not in pt.db._host_delta
    human = pt.db.get_node_handle("Concept", "human")
    assert len(pt.db.get_matched_links("List", [human, WILDCARD, WILDCARD])) == 1
    lst = ("L", "List", [_c("human"), V1, V2], True)
    _check(pair, QUERIES + [lst])
    _commit_both(pair, ['(List "monkey" "chimp" "human")'])   # a delta on the new arity
    _check(pair, QUERIES + [lst, ("L", "List", [V1, V2, _c("human")], True)])


def _dangle(das, expr_mod, hashing_mod):
    """An Inheritance(human, ghost) link whose target does not exist yet
    (the canonical loader's partial-KB shape)."""
    t = das.data.table
    inh = t.get_named_type_hash("Inheritance")
    concept = t.get_named_type_hash("Concept")
    H = hashing_mod.ExpressionHasher
    elements = [H.terminal_hash("Concept", "human"), H.terminal_hash("Concept", "ghost")]
    das.data.add_link(expr_mod.Expression(
        toplevel=True, named_type="Inheritance", named_type_hash=inh,
        composite_type=[inh, concept, concept],
        composite_type_hash=H.composite_hash([inh, concept, concept]),
        elements=elements, hash_code=H.expression_hash(inh, elements)))
    das._refresh()


def test_dangling_target_forces_rebuild():
    from das_tpu.core import expression as jx_expression
    from das_tpu.core import hashing as jx_hashing
    from das_tpu_torch.core import expression, hashing

    jx, pt = pair = _pair()
    _dangle(jx, jx_expression, jx_hashing)
    _dangle(pt, expression, hashing)
    assert pt.db.fin.dangling_hexes
    _check(pair)
    _commit_both(pair, ['(: "ghost" Concept)', '(Inheritance "ghost" "mammal")'])
    assert pt.db._delta_total == 0          # rebuilt, not incremental
    ghost = pt.db.get_node_handle("Concept", "ghost")
    assert len(pt.db.get_matched_links("Inheritance", [WILDCARD, ghost])) == 1
    assert len(pt.db.get_incoming(ghost)) == 2
    _check(pair, QUERIES + [_inh(V1, _c("ghost"))])


def test_shared_finalized_no_double_intern():
    """Two device backends over one AtomSpaceData share its Finalized: a
    commit both refresh interns each atom once, and both answer on it."""
    got, stores = {}, {}
    for label, tdb, load, text, m in (
            ("jx", lambda d: JxTensorDB(d, JxConfig(use_planner="off")), jx_load,
             jx_animals(), jx_ast),
            ("pt", lambda d: TensorDB(d, DasConfig(use_planner="off"), device="cpu"),
             load_metta_text, animals_metta(), ast)):
        data = load(text)
        a, b = tdb(data), tdb(data)
        assert a.fin is b.fin
        base_rows = len(a.fin.hex_of_row)
        load('(: "lion" Concept)\n(Inheritance "lion" "mammal")', data)
        a.refresh()
        b.refresh()
        assert len(a.fin.hex_of_row) == len(set(a.fin.hex_of_row)) == base_rows + 2
        q = _build(m, _inh(_c("lion"), V1))
        out = []
        for db in (a, b):
            answer = m.PatternMatchingAnswer()
            assert (jx_compiler if label == "jx" else compiler).query_on_device(db, q, answer)
            out.append(sorted(repr(x) for x in answer.assignments))
        assert out[0] == out[1] and len(out[0]) == 1
        got[label] = (out[0], a.delta_version, a._delta_total, b._delta_total)
        stores[label] = (a, b)
    assert got["jx"] == got["pt"]
    for jdb, pdb in zip(stores["jx"], stores["pt"]):
        _assert_tables_equal(_jx_tables(jdb), pdb.dev)


def test_count_batch_after_commit():
    jx, pt = pair = _pair()
    spec = ("And", [_inh(V1, _c("mammal")), _inh(V1, V2)])
    counts = {}
    for das, comp, fz, m in ((jx, jx_compiler, jx_fused, jx_ast), (pt, compiler, fused, ast)):
        plans = [comp.plan_query(das.db, _build(m, spec))]
        before = fz.get_executor(das.db).count_batch(plans)
        _commit(das, LION_TIGER)
        plans = [comp.plan_query(das.db, _build(m, spec))]
        after = fz.get_executor(das.db).count_batch(plans)
        counts[m is ast] = (before, after)
    assert counts[True] == counts[False]
    assert counts[True][1][0] > counts[True][0][0]
    _check(pair)


def test_capacity_growth():
    pair = _pair()
    jx, pt = pair
    cap0 = pt.db.dev.buckets[2].capacity
    k = total = 0
    while pt.db.dev.buckets[2].capacity == cap0:
        lines = [f'(: "g{k}_{i}" Concept)' for i in range(40)]
        lines += [f'(Inheritance "g{k}_{i}" "mammal")' for i in range(40)]
        _commit_both(pair, lines)
        total += 40
        k += 1
        assert k < 20, "growth never triggered"
        _check(pair, QUERIES[:2])
    assert pt.db.dev.buckets[2].size == 26 + total
    assert pt.db._delta_total == 80 * k          # incremental all the way
    mammal = pt.db.get_node_handle("Concept", "mammal")
    assert len(pt.db.get_matched_links("Inheritance", [WILDCARD, mammal])) == 4 + total
    fresh = DistributedAtomSpace(backend="tensor", data=pt.data, device="cpu",
                                 config=DasConfig(use_planner="off"))
    q = _build(ast, _inh(V1, _c("mammal")))
    assert _answer(pt, q) == _answer(fresh, q)


def _sorted_with_ties(rng, n, dtype, hi, n_pad):
    keys = np.sort(rng.integers(0, hi, n)).astype(dtype)
    return np.concatenate([keys, np.full(n_pad, np.iinfo(dtype).max, dtype=dtype)])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("nb,nd", [(200, 64), (64, 0), (0, 64), (517, 128)])
def test_merge_sorted_index_matches_jax(dtype, nb, nd):
    rng = np.random.default_rng(nb * 7 + nd)
    hi = 40 if dtype == np.int32 else 1 << 40       # few values: many ties
    bk = _sorted_with_ties(rng, nb, dtype, hi, nb // 8)
    dk = _sorted_with_ties(rng, nd, dtype, hi, nd // 4)
    bo = rng.permutation(bk.shape[0]).astype(np.int32)
    do = (rng.permutation(dk.shape[0]) + bk.shape[0]).astype(np.int32)
    wk, wp = jx_merge(bk, bo, dk, do)
    gk, gp = merge_sorted_index(*(torch.from_numpy(x) for x in (bk, bo, dk, do)))
    assert gk.dtype == torch.from_numpy(bk).dtype and gp.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(wk), gk.numpy())
    np.testing.assert_array_equal(np.asarray(wp), gp.numpy())


def test_failed_staging_leaves_store_unchanged(monkeypatch):
    """A commit of two arities whose second staging raises changes nothing
    visible; the same commit then succeeds and equals das_tpu's."""
    jx, pt = pair = _pair()
    _commit_both(pair, LIST3[:1] + ['(List "human" "monkey" "chimp")'])
    db = pt.db
    buckets = dict(db.dev.buckets)
    version, total = db.delta_version, db._delta_total
    want = [_answer(pt, _build(ast, spec)) for spec in QUERIES]
    calls = []
    stage = TensorDB._stage_delta_merge

    def failing(self, delta):
        calls.append(delta.arity)
        if len(calls) == 2:
            raise RuntimeError("staging failed")
        return stage(self, delta)

    monkeypatch.setattr(TensorDB, "_stage_delta_merge", failing)
    lines = ['(: "lion" Concept)', '(Inheritance "lion" "mammal")',
             '(List "lion" "human" "monkey")']
    with pytest.raises(RuntimeError, match="staging failed"):
        _commit(pt, lines)
    assert calls == [2, 3]
    assert db.delta_version == version and db._delta_total == total
    assert all(db.dev.buckets[a] is b for a, b in buckets.items())
    assert [_answer(pt, _build(ast, spec)) for spec in QUERIES] == want
    monkeypatch.setattr(TensorDB, "_stage_delta_merge", stage)
    pt._refresh()
    _commit(jx, lines)
    assert db.delta_version == version + 1
    _check(pair, QUERIES + [("L", "List", [_c("lion"), V1, V2], True)])


def test_result_cache_across_commit():
    jx, pt = pair = _pair()
    specs = [QUERIES[0], QUERIES[1], QUERIES[2]]
    stats = {}
    for das, fz, m in ((jx, jx_fused, jx_ast), (pt, fused, ast)):
        batch = [_build(m, s) for s in specs]
        first = das.query_many(batch)
        assert das.query_many(batch) == first
        _commit(das, LION_TIGER)
        after = das.query_many(batch)
        assert after == [das.query(q) for q in batch] and after != first
        stats[m is ast] = fz.result_cache_stats(das.db)
    assert stats[True] == stats[False]
    assert stats[True]["invalidations"] == 1
    _check(pair)


def test_batch_dispatched_before_commit():
    jx, pt = pair = _pair()
    specs = [QUERIES[0], QUERIES[1]]
    got = {}
    for das, m in ((jx, jx_ast), (pt, ast)):
        batch = [_build(m, s) for s in specs]
        before = das.query_many(batch)
        job = das.query_many_dispatch(batch)
        _commit(das, LION_TIGER)
        after = job.settle()
        assert after == [das.query(q) for q in batch]
        lion = das.get_atom(das.db.get_node_handle("Concept", "lion"))
        assert lion not in before[0] and lion in after[0]
        got[m is ast] = [_answer(das, q) for q in batch]
    assert got[True] == got[False]
    _check(pair)
