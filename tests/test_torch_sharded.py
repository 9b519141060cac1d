"""The port's sharded store (das_tpu_torch/parallel/sharded_db.py and
fused_sharded.py, 8 shards on device="cpu") against das_tpu's sharded
backend on 8 virtual CPU devices (tests/conftest.py):

  * answers, as sets, against das_tpu's ShardedDB and MemoryDB on the
    query set of tests/test_sharded.py and two Or trees (unordered links
    and nesting are in tests/test_torch_sharded_tree.py);
  * the fused sharded executor's stats vector, per-shard tables, rounds
    and capacities bit for bit on bio shapes that reach the probe, the
    index join, broadcast-right and hash-partitioned joins, the anti join
    and the multiway step, and the overflow retry rounds;
  * plan_conjunction(n_shards=8) field for field;
  * query_many through the sharded halves and the result cache, explain,
    and the route counters."""

import numpy as np
import pytest

from das_tpu import planner as jx_planner
from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.parallel import fused_sharded as jx_fs
from das_tpu.parallel.mesh import make_mesh as jx_make_mesh
from das_tpu.parallel.sharded_db import ShardedDB as JxShardedDB
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu.storage.memory_db import MemoryDB as JxMemoryDB
from das_tpu_torch import planner
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.parallel import fused_sharded as fs
from das_tpu_torch.parallel.sharded_db import ShardedDB
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query import fused
from das_tpu_torch.storage.atom_table import load_metta_text
from tests.test_differential import canon

S = 8
BIO = dict(n_genes=40, n_processes=10, members_per_gene=3, n_interactions=50, seed=5)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_STAR",
                "DAS_TPU_TREE_FUSION", "DAS_TPU_VMEM_BUDGET", "DAS_TPU_PLANNER_DP_MAX"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def animals():
    jdata = jx_load(jx_animals())
    return (JxShardedDB(jdata, JxConfig(), mesh=jx_make_mesh(S)), JxMemoryDB(jdata),
            ShardedDB(load_metta_text(animals_metta()), DasConfig(mesh_shape=(S,)),
                      device="cpu"))


def _bio(**cfg):
    jdata, genes, _ = jx_bio(**BIO)
    pdata, _, _ = build_bio_atomspace(**BIO)
    names = [jdata.nodes[h].name for h in genes]
    return (JxShardedDB(jdata, JxConfig(**cfg), mesh=jx_make_mesh(S)),
            ShardedDB(pdata, DasConfig(mesh_shape=(S,), **cfg), device="cpu"), names)


@pytest.fixture(scope="module")
def bio_on():
    return _bio(use_multiway="on")


@pytest.fixture(scope="module")
def bio_off():
    return _bio(use_multiway="off")


def _animal_queries(m):
    L, V, N, TV = m.Link, m.Variable, m.Node, m.TypedVariable
    return [
        L("Inheritance", [V("V1"), N("Concept", "mammal")], True),
        L("Inheritance", [V("V1"), V("V2")], True),
        m.And([L("Inheritance", [V("V1"), V("V2")], True),
               L("Inheritance", [V("V2"), V("V3")], True)]),
        m.And([L("Inheritance", [V("V1"), V("V3")], True),
               L("Inheritance", [V("V2"), V("V3")], True),
               m.Not(L("Inheritance", [V("V1"), N("Concept", "mammal")], True))]),
        m.LinkTemplate("Inheritance", [TV("V1", "Concept"), TV("V2", "Concept")], True),
        m.And([m.LinkTemplate("Inheritance", [TV("V1", "Concept"), TV("V2", "Concept")], True),
               L("Inheritance", [V("V2"), V("V3")], True)]),
        # zero answers: an empty positive term is definitive
        m.And([L("Inheritance", [V("V1"), N("Concept", "mammal")], True),
               L("Inheritance", [V("V1"), N("Concept", "plant")], True)]),
        m.Or([L("Inheritance", [V("V1"), N("Concept", "mammal")], True),
              L("Inheritance", [V("V1"), N("Concept", "reptile")], True)]),
        m.Or([L("Inheritance", [V("V1"), N("Concept", "mammal")], True),
              m.Not(L("Inheritance", [V("V1"), N("Concept", "reptile")], True))]),
    ]


N_ANIMAL = len(_animal_queries(ast))


def _answer(mod, db, q):
    a = mod.PatternMatchingAnswer()
    matched = mod_dispatch(mod, db, q, a)
    return bool(matched), a.negation, {canon(x) for x in a.assignments}


def mod_dispatch(mod, db, q, a):
    return (jx_compiler if mod is jx_ast else compiler).dispatch(db, q, a)


@pytest.mark.parametrize("qi", range(N_ANIMAL))
def test_answers_equal_das_tpu_and_memory(animals, qi):
    jdb, mdb, pdb = animals
    jq, pq = _animal_queries(jx_ast)[qi], _animal_queries(ast)[qi]
    host = jx_ast.PatternMatchingAnswer()
    host_matched = jq.matched(mdb, host)
    want = (bool(host_matched), host.negation, {canon(x) for x in host.assignments})
    assert _answer(jx_ast, jdb, jq) == want
    assert _answer(ast, pdb, pq) == want


def test_route_counters_equal_das_tpu(animals):
    jdb, _, pdb = animals
    jx_compiler.reset_route_counts()
    compiler.reset_route_counts()
    for jq, pq in zip(_animal_queries(jx_ast), _animal_queries(ast)):
        _answer(jx_ast, jdb, jq)
        _answer(ast, pdb, pq)
    for key in ("sharded", "sharded_kernel", "sharded_tree_fused", "sharded_multiway", "host",
                "tree", "fused"):
        assert compiler.ROUTE_COUNTS[key] == jx_compiler.ROUTE_COUNTS[key], key
    assert compiler.ROUTE_COUNTS["sharded"] == N_ANIMAL


def _bio_suite(m, names):
    L, V, N = m.Link, m.Variable, m.Node
    g0, g1 = names[:2]
    return [
        L("Member", [N("Gene", g0), V("V3")], True),                       # probe only
        m.And([L("Member", [V("V1"), V("V3")], True),                      # star (multiway)
               L("Member", [V("V2"), V("V3")], True),
               L("Member", [V("V4"), V("V3")], True)]),
        m.And([L("Member", [N("Gene", g0), V("V3")], True),                # index join
               L("Member", [V("V2"), V("V3")], True)]),
        m.And([L("Member", [V("V1"), V("V3")], True),                      # grounded right
               L("Member", [N("Gene", g1), V("V3")], True),
               L("Interacts", [V("V1"), V("V2")], True)]),
        m.And([L("Member", [V("V2"), V("V3")], True),                      # anti join
               L("Member", [N("Gene", g1), V("V3")], True),
               m.Not(L("Interacts", [N("Gene", g1), V("V2")], True))]),
        m.And([L("Interacts", [V("V1"), V("V2")], True),                   # chain
               L("Interacts", [V("V2"), V("V3")], True)]),
    ]


def _jx_job(ex, plans):
    import jax

    job = ex._exec_job(plans, False)
    while True:
        out = job.dispatch()
        host = jax.device_get(out)
        if job.settle(host, out):
            return job, host


def _pt_job(ex, plans):
    job = ex._exec_job(plans, False)
    while True:
        out = job.dispatch()
        host = fused.fetch(*out)
        if job.settle(host, out):
            return job, host


#: the bio suite's queries each case runs (JAX compiles dominate the time)
CASES = {"multiway_on": (1, 4), "chain": (0, 2, 3), "partitioned": (3,), "small_caps": (5,)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_sharded_equals_das_tpu(case, request, monkeypatch):
    jdb, pdb, names = request.getfixturevalue("bio_on" if case == "multiway_on" else "bio_off")
    jex, pex = jx_fs.get_sharded_executor(jdb), fs.get_sharded_executor(pdb)
    for ex in (jex, pex):
        ex._caps.clear()
        ex.broadcast_limit = 0 if case == "partitioned" else fs.BROADCAST_LIMIT
    if case == "small_caps":
        # the greedy order's blind seeds (the planner seeds from exact
        # statistics and would settle in round 0)
        for db in (jdb, pdb):
            monkeypatch.setattr(db.config, "initial_result_capacity", 16)
            monkeypatch.setattr(db.config, "use_planner", "off")
    seen = {"index": 0, "broadcast": 0, "partitioned": 0, "multiway": 0, "anti": 0,
            "retried": 0}
    for qi in CASES[case]:
        jplans = jx_compiler.plan_query(jdb, _bio_suite(jx_ast, names)[qi])
        pplans = compiler.plan_query(pdb, _bio_suite(ast, names)[qi])
        # small_caps runs again from the learned caps
        for _ in range(2 if case == "small_caps" else 1):
            jj, jh = _jx_job(jex, jplans)
            pj, ph = _pt_job(pex, pplans)
            jv, jm, js = jh
            assert [int(x) for x in ph[0]] == [int(x) for x in js]
            assert np.array_equal(pj.result.host_vals, np.asarray(jv))
            assert np.array_equal(pj.result.host_valid, np.asarray(jm))
            assert (pj.rounds, pj.multiway, pj.index_joins) == (jj.rounds, jj.multiway,
                                                               jj.index_joins)
            assert (pj.term_caps, pj.join_caps, pj.exch_caps) == (jj.term_caps, jj.join_caps,
                                                                jj.exch_caps)
            assert pj.result.reseed_needed == jj.result.reseed_needed
            assert pj.result.count == jj.result.count
            seen["index"] += sum(1 for p in pj.index_joins if p >= 0)
            step0 = 1 if pj.multiway else 0
            tail = pj.exch_caps[step0:]
            seen["partitioned"] += sum(1 for q in tail if q > 0)
            seen["broadcast"] += sum(1 for q, ij in zip(tail, pj.index_joins)
                                     if q == 0 and ij < 0)
            seen["multiway"] += bool(pj.multiway)
            seen["anti"] += any(s.negated for s in pj.sigs)
            seen["retried"] += pj.rounds > 1
    if case == "multiway_on":
        assert seen["multiway"] > 0 and seen["anti"] > 0
    if case == "chain":
        assert seen["index"] > 0 and seen["broadcast"] > 0
    if case == "partitioned":
        assert seen["partitioned"] > 0
    if case == "small_caps":
        assert seen["retried"] > 0


def test_partitioned_whole_type_join_equals_das_tpu(bio_off, monkeypatch):
    """With index joins off in both packages and no broadcast, a chain of
    whole-type terms hash-partitions both sides of every join."""
    import das_tpu.query.fused as jx_fused

    jdb, pdb, names = bio_off

    def no_index(sigs, start=0):
        n = sum(1 for s in sigs if not s.negated)
        return tuple([-1] * max(0, n - 1 - start)), {}

    monkeypatch.setattr(jx_fused, "plan_index_joins", no_index)
    monkeypatch.setattr(fused, "plan_index_joins", no_index)
    jex, pex = jx_fs.get_sharded_executor(jdb), fs.get_sharded_executor(pdb)
    for ex in (jex, pex):
        ex._caps.clear()
        monkeypatch.setattr(ex, "broadcast_limit", 0)
    q = lambda m: m.And([m.Link("Interacts", [m.Variable("V1"), m.Variable("V2")], True),  # noqa: E731
                         m.Link("Member", [m.Variable("V1"), m.Variable("V3")], True)])
    jj, jh = _jx_job(jex, jx_compiler.plan_query(jdb, q(jx_ast)))
    pj, ph = _pt_job(pex, compiler.plan_query(pdb, q(ast)))
    assert pj.exch_caps == jj.exch_caps and pj.exch_caps[0] > 0
    assert [int(x) for x in ph[0]] == [int(x) for x in jh[2]]
    assert np.array_equal(pj.result.host_vals, np.asarray(jh[0]))
    assert np.array_equal(pj.result.host_valid, np.asarray(jh[1]))


def test_plan_conjunction_sharded_fields(bio_on):
    jdb, pdb, names = bio_on
    for jq, pq in zip(_bio_suite(jx_ast, names), _bio_suite(ast, names)):
        want = jx_planner.plan_conjunction(jdb, jx_compiler.plan_query(jdb, jq), n_shards=S)
        got = planner.plan_conjunction(pdb, compiler.plan_query(pdb, pq), n_shards=S)
        if want is None:
            assert got is None
            continue
        for field in ("order", "est_term_rows", "est_join_rows", "join_cap_seeds", "route",
                      "method", "multiway"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.cost == pytest.approx(want.cost)
        assert got.route.startswith("sharded")


def _facades():
    jdata, genes, _ = jx_bio(**BIO)
    pdata, _, _ = build_bio_atomspace(**BIO)
    jx = JxDAS(backend="sharded", data=jdata, config=JxConfig())
    pt = DistributedAtomSpace(backend="sharded", data=pdata, device="cpu",
                              config=DasConfig(mesh_shape=(S,)))
    return jx, pt, [jdata.nodes[h].name for h in genes]


@pytest.fixture(scope="module")
def facades():
    return _facades()


def test_query_many_sharded_halves_and_cache(facades):
    jx, pt, names = facades
    pqs = _bio_suite(ast, names) + [_bio_suite(ast, names)[2]]   # one duplicate
    jqs = _bio_suite(jx_ast, names) + [_bio_suite(jx_ast, names)[2]]
    compiler.reset_route_counts()
    first = pt.query_many(pqs)
    assert first == [pt.query(q) for q in pqs]
    assert compiler.ROUTE_COUNTS["sharded"] >= len(pqs)
    for pq, jq in zip(pqs, jqs):
        assert {canon(a) for a in pt.query_answer(pq)[1].assignments} == \
            {canon(a) for a in jx.query_answer(jq)[1].assignments}
    before = fused.result_cache_stats(pt.db)
    fetches = fused.FETCH_COUNTS["n"]
    again = pt.query_many(pqs)
    after = fused.result_cache_stats(pt.db)
    assert again == first
    assert fused.FETCH_COUNTS["n"] == fetches
    # a duplicate of a hit looks the cache up itself
    assert after["hits"] - before["hits"] == len(pqs)


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k != "compile"}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    if isinstance(d, tuple):
        return [_strip(x) for x in d]
    return d


def test_explain_equals_das_tpu(facades):
    jx, pt, names = facades
    L, V, N = ast.Link, ast.Variable, ast.Node
    jL, jV, jN = jx_ast.Link, jx_ast.Variable, jx_ast.Node

    def orq(m, L, V, N):
        return m.Or([m.And([L("Member", [N("Gene", g), V("V3")], True),
                            L("Member", [V("V2"), V("V3")], True)]) for g in names[:2]])

    pairs = list(zip(_bio_suite(jx_ast, names)[1:4], _bio_suite(ast, names)[1:4]))
    pairs.append((orq(jx_ast, jL, jV, jN), orq(ast, L, V, N)))
    for jq, pq in pairs:
        for execute in (False, True):
            want = _strip(jx.explain(jq, execute=execute))
            got = _strip(pt.explain(pq, execute=execute))
            assert got == want
    assert pt.explain(pairs[-1][1], execute=True)["actual"]["count_is_upper_bound"] is True
