"""The batched serving path of the port (das_tpu_torch, device="cpu")
against the JAX package's (das_tpu, JAX on the CPU), planner and multiway
off in both: `query_many`, `query_many_dispatch(...).settle()`,
`execute_many`, `settle_many_iter` and `execute_exact` give the same
answers, host fetches, fused/staged routes and result-cache statistics;
a batch dispatched before a load answers on the loaded store; degraded
mode (`cache_only`) answers hits and rejects misses; the cache's limits
hold; `count_matches` returns None where das_tpu's does."""

import ast as pyast
import re

import numpy as np
import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.core.exceptions import BreakerOpenError as JxBreakerOpenError
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import assignment as jx_assignment
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query import fused as jx_fused
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import BreakerOpenError
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import assignment
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query import fused
from das_tpu_torch.storage.atom_table import load_metta_text

#: bench.py SMALL
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5, n_interactions=300,
             n_evaluations=0, seed=5)

#: the two packages side by side: (label, query AST module, compiler,
#: fused module, BreakerOpenError)
JX = ("jx", jx_ast, jx_compiler, jx_fused, JxBreakerOpenError)
PT = ("pt", ast, compiler, fused, BreakerOpenError)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS",
                "DAS_TPU_VMEM_BUDGET", "DAS_TPU_STAR"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bio():
    jdata, genes, _ = jx_bio(**SMALL)
    pdata, _, _ = build_bio_atomspace(**SMALL)
    return jdata, pdata, [jdata.nodes[h].name for h in genes]


def _pair(jdata, pdata, **cfg):
    """A JAX and a port facade over the same data, planner and multiway
    off, with `cfg` in both configs."""
    jx = JxDAS(backend="tensor", data=jdata,
               config=JxConfig(use_planner="off", use_multiway="off", **cfg))
    pt = DistributedAtomSpace(backend="tensor", data=pdata, device="cpu",
                              config=DasConfig(use_planner="off", use_multiway="off", **cfg))
    return jx, pt


def _parse(s):
    """Package-independent identity of one answer string: the NOT tag and
    the set of variable -> handle mappings (each assignment's repr is its
    mapping dict)."""
    maps = sorted(tuple(sorted(pyast.literal_eval(d).items()))
                  for d in re.findall(r"\{[^{}]*\}", s))
    return s.startswith("NOT "), maps


# -- queries (the same in either package) ------------------------------------


def grounded(m, g, negate=False):
    L, V, N = m.Link, m.Variable, m.Node
    third = L("Interacts", [N("Gene", g), V("V2")], True)
    return m.And([L("Member", [N("Gene", g), V("V3")], True),
                  L("Member", [V("V2"), V("V3")], True),
                  m.Not(third) if negate else third])


def reseed(m, g1, g2, g3=None):
    """Two grounded Member terms that may share no process, then an
    Interacts term that re-seeds the emptied accumulator (grounded on g3,
    or the whole type)."""
    L, V, N = m.Link, m.Variable, m.Node
    third = (L("Interacts", [N("Gene", g3), V("V2")], True) if g3 is not None
             else L("Interacts", [V("V1"), V("V2")], True))
    return m.And([L("Member", [N("Gene", g1), V("V3")], True),
                  L("Member", [N("Gene", g2), V("V3")], True), third])


def triangle(m):
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("V1"), V("V3")], True), L("Member", [V("V2"), V("V3")], True),
                  L("Interacts", [V("V1"), V("V2")], True)])


def either(m, g):
    L, V, N = m.Link, m.Variable, m.Node
    return m.Or([L("Member", [N("Gene", g), V("V3")], True),
                 L("Interacts", [N("Gene", g), V("V3")], True)])


def unknown(m):
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Member", [N("Gene", "no such gene"), V("V3")], True),
                  L("Member", [V("V2"), V("V3")], True)])


def mixed(m, names):
    """Grounded, Not, four reseed shapes, an Or, a query naming an unknown
    atom, a duplicate of the first entry and the all-variable triangle
    (past its first capacities at initial_result_capacity=64)."""
    return ([grounded(m, names[0]), grounded(m, names[1], True)]
            + [reseed(m, names[10 + i], names[20 + i]) for i in range(4)]
            + [either(m, names[2]), unknown(m), grounded(m, names[0]), triangle(m)])


def _disjoint_pairs(pt, names, n):
    """n (g1, g2) gene pairs that share no process: reseed() of such a pair
    re-seeds on its third term."""
    out = []
    for i in range(10, len(names)):
        g1, g2 = names[i], names[i + 100]
        L, V, N = ast.Link, ast.Variable, ast.Node
        both = ast.And([L("Member", [N("Gene", g1), V("V3")], True),
                        L("Member", [N("Gene", g2), V("V3")], True)])
        if compiler.count_matches(pt.db, both) == 0:
            out.append((g1, g2))
            if len(out) == n:
                return out
    raise AssertionError("too few disjoint gene pairs")


def _run_batch(das, queries, pkg, dispatch=False):
    """(answer strings, host fetches of the fused batch, fused/staged route
    deltas, the job's settle_rtt_ms when dispatched).  The per-query
    fallbacks of non-compilable entries go through `das.query`, where the
    tree executor answers: their fetches are counted apart and left out."""
    _label, _m, comp, fz, _err = pkg
    apart = {"n": 0}
    single = das.query

    def query(q, *a):
        f0 = fz.FETCH_COUNTS["n"]
        try:
            return single(q, *a)
        finally:
            apart["n"] += fz.FETCH_COUNTS["n"] - f0

    das.query = query
    r0 = dict(comp.ROUTE_COUNTS)
    f0 = fz.FETCH_COUNTS["n"]
    rtt = None
    try:
        if dispatch:
            job = das.query_many_dispatch(queries)
            out = job.settle()
            rtt = job.settle_rtt_ms
        else:
            out = das.query_many(queries)
    finally:
        del das.query
    routes = {k: comp.ROUTE_COUNTS[k] - r0[k] for k in ("fused", "staged")}
    return out, fz.FETCH_COUNTS["n"] - f0 - apart["n"], routes, rtt


def _cache_stats(das, pkg):
    """The executor's result-cache statistics: the conjunctive cache's and
    the tree executor's, summed (`result_cache_stats` in both packages)."""
    _label, _m, _comp, fz, _err = pkg
    return fz.result_cache_stats(das.db)


def test_mixed_batch_matches_das_tpu(bio):
    jdata, pdata, names = bio
    jx, pt = _pair(jdata, pdata, initial_result_capacity=64)
    pkgs = ((jx, JX), (pt, PT))
    batches = [("first", mixed, True), ("repeat", mixed, False),
               ("duplicates", lambda m, n: [grounded(m, n[30]), grounded(m, n[31], True),
                                            grounded(m, n[30]), reseed(m, n[12], n[22]),
                                            grounded(m, n[31], True)], False)]
    for label, build, dispatch in batches:
        got = {}
        for das, pkg in pkgs:
            queries = build(pkg[1], names)
            out, fetches, routes, rtt = _run_batch(das, queries, pkg, dispatch)
            got[pkg[0]] = ([_parse(s) for s in out], fetches, routes, _cache_stats(das, pkg))
            # the settle round-trip is the first round's fetch
            assert (rtt is not None and rtt > 0) == (label == "first"), label
            # both packages answer the batch again one query at a time, so
            # that their caches see the same traffic (the tree cache hits)
            single = [das.query(q) for q in queries]
            if pkg is PT:
                assert out == single, label
        assert got["jx"] == got["pt"], label
        answers, fetches, routes, stats = got["pt"]
        if label == "first":
            assert routes == {"fused": 8, "staged": 0}
            assert answers[0] == answers[8] and answers[0][1]    # the duplicate
            assert answers[6][1] and not answers[7][1]     # the Or; the unknown atom
            assert 1 < fetches < len(answers)   # retry rounds, not one per query
            # 7 conjunctive misses, and one each in the tree cache for the
            # Or (its whole-tree job) and the unknown atom (the staged tree)
            assert stats == {"hits": 0, "misses": 9, "invalidations": 0}
        if label == "repeat":
            # a re-seeded result is never cached: its entry misses again
            assert stats["misses"] > 9 and fetches >= 1
    # the triangle ran more than one round; one fetch per round
    plans = [compiler.plan_query(pt.db, q) for q in mixed(ast, names)]
    compilable = [p for p in plans if p is not None]
    fresh = DistributedAtomSpace(backend="tensor", data=pdata, device="cpu",
                                 config=DasConfig(use_planner="off", use_multiway="off",
                                                  initial_result_capacity=64))
    f0 = fused.FETCH_COUNTS["n"]
    results = fused.get_executor(fresh.db).execute_many(compilable)
    rounds = max(r.rounds for r in results)
    assert results[-1].rounds >= 2 and fused.FETCH_COUNTS["n"] - f0 == rounds


def test_settle_many_iter_order_matches_das_tpu(bio):
    """Every index once, in das_tpu's order: cache hits first, then each
    retry round's verdicts; execute_many's counts and flags agree."""
    jdata, pdata, names = bio
    jx, pt = _pair(jdata, pdata, initial_result_capacity=64)
    order, counts = {}, {}
    for das, pkg in ((jx, JX), (pt, PT)):
        m, comp, fz = pkg[1], pkg[2], pkg[3]
        ex = fz.get_executor(das.db)
        warm = [comp.plan_query(das.db, q) for q in (grounded(m, names[3]), triangle(m))]
        ex.execute_many(warm)
        queries = [triangle(m), grounded(m, names[4]), reseed(m, names[11], names[21]),
                   grounded(m, names[3]), grounded(m, names[4]), grounded(m, names[5], True)]
        plans = [comp.plan_query(das.db, q) for q in queries]
        pending = ex.dispatch_many(plans)
        order[pkg[0]] = [i for i, _r in ex.settle_many_iter(pending)]
        counts[pkg[0]] = [(r.count, r.reseed_needed, r.var_names)
                          for r in ex.execute_many(plans)]
        # the compiler's batched form: reseed entries answered in place
        counts[pkg[0]].append([(t.var_names, t.count)
                               for t in comp.execute_fused_many(das.db, plans)])
    assert order["jx"] == order["pt"]
    assert sorted(order["pt"]) == list(range(6)) and order["pt"][:2] == [0, 3]
    assert counts["jx"] == counts["pt"]


def _jx_exact_stats(ex, plans):
    """das_tpu's exact program's stats vector at its learned capacities."""
    mapped = [ex._term_args(p) for p in plans]
    sigs = tuple(t[0] for t in mapped)
    sig = jx_fused.FusedExactSig(sigs, *ex._exact_caps[sigs])
    fn, _names, _cols = ex._exact_cache[(sig, False)]
    out = fn(tuple(t[1] for t in mapped), tuple(t[2] for t in mapped),
             tuple(t[3] for t in mapped))
    return np.asarray(out[2]).tolist()


def _row_set(res):
    return {tuple(r) for r in res.host_vals[res.host_valid].tolist()}


def test_execute_exact_matches_das_tpu(bio):
    """Reseed shapes (disjoint and sharing Member pairs, a grounded and a
    whole-type third term) and one whose last positive term is empty."""
    jdata, pdata, names = bio
    jx, pt = _pair(jdata, pdata)
    lonely = next(g for g in names
                  if compiler.count_matches(pt.db, ast.Link(
                      "Interacts", [ast.Node("Gene", g), ast.Variable("V2")], True)) == 0)
    shapes = [lambda m: reseed(m, names[10], names[20]),
              lambda m: reseed(m, names[11], names[21]),
              lambda m: reseed(m, names[12], names[22], names[40]),
              lambda m: reseed(m, names[13], names[23], lonely)]
    jex, pex = jx_fused.get_executor(jx.db), fused.get_executor(pt.db)
    re_seeded = 0
    for build in shapes:
        jplans = jx_compiler.plan_query(jx.db, build(jx_ast))
        pplans = compiler.plan_query(pt.db, build(ast))
        want = jex.execute_exact(jplans)
        got = pex.execute_exact(pplans)
        assert (got.var_names, got.count) == (want.var_names, want.count)
        assert got.stats.tolist() == _jx_exact_stats(jex, jplans)
        assert _row_set(got) == _row_set(want)
        assert got.count == int(got.host_valid.sum()) and not got.reseed_needed
        re_seeded += int(got.stats[1]) > 0
        n = pex.execute_exact(pplans, count_only=True)
        assert n.count == got.count and n.vals is None
    assert re_seeded >= 1


def test_stale_batch_answers_after_load():
    """A batch dispatched before a load settles on the loaded store: the
    new Inheritance link's answer is in it, in both packages."""
    q = [("L", "Inheritance", [("V", "V1"), ("N", "Concept", "mammal")]),
         ("L", "Inheritance", [("V", "V1"), ("V", "V2")])]
    new = '(: "dog" Concept)\n(Inheritance "dog" "mammal")\n'

    def build(m, spec):
        kind, t, targets = spec
        return m.Link(t, [m.Variable(x[1]) if x[0] == "V" else m.Node(x[1], x[2])
                          for x in targets], True)

    got = {}
    for pkg, das in ((JX, JxDAS(backend="tensor", data=jx_load(jx_animals()),
                                config=JxConfig(use_planner="off", use_multiway="off"))),
                     (PT, DistributedAtomSpace(backend="tensor", device="cpu",
                                               data=load_metta_text(animals_metta())))):
        queries = [build(pkg[1], s) for s in q]
        before = das.query_many(queries)
        job = das.query_many_dispatch(queries)
        das.load_metta_text(new)
        after = job.settle()
        assert after == [das.query(x) for x in queries]
        dog = das.get_atom(das.db.get_node_handle("Concept", "dog"))
        assert dog not in before[0] and dog in after[0] and dog in after[1]
        got[pkg[0]] = [_parse(s) for s in after]
    assert got["jx"] == got["pt"]


def test_cache_only_answers_hits_and_rejects_misses(bio):
    jdata, pdata, names = bio
    jx, pt = _pair(jdata, pdata)
    for das, pkg in ((jx, JX), (pt, PT)):
        m, fz, err = pkg[1], pkg[3], pkg[4]
        hit = grounded(m, names[6])
        warm = das.query_many([hit, grounded(m, names[7], True)])
        f0 = fz.FETCH_COUNTS["n"]
        out = das.query_many_dispatch([hit, grounded(m, names[8]), either(m, names[8])],
                                      cache_only=True).settle()
        assert out[0] == warm[0] and fz.FETCH_COUNTS["n"] == f0
        assert isinstance(out[1], err) and isinstance(out[2], err)


def test_result_cache_limits(bio):
    """result_cache_size=0 caches nothing; a reseed-flagged result is never
    cached, so its repeat runs the device again."""
    jdata, pdata, names = bio
    for size in (0, 256):
        jx, pt = _pair(jdata, pdata, result_cache_size=size)
        got = {}
        g1, g2 = _disjoint_pairs(pt, names, 1)[0]
        for das, pkg in ((jx, JX), (pt, PT)):
            m, fz = pkg[1], pkg[3]
            queries = [grounded(m, names[9]), reseed(m, g1, g2)]
            for _ in range(2):
                f0 = fz.FETCH_COUNTS["n"]
                das.query_many(queries)
                fetches = fz.FETCH_COUNTS["n"] - f0
            cached = list(fz.get_executor(das.db).results._data.values())
            got[pkg[0]] = (fetches, _cache_stats(das, pkg), len(cached))
            assert not any(r.reseed_needed for r in cached)
        assert got["jx"] == got["pt"]
        fetches, stats, n_cached = got["pt"]
        if size == 0:
            assert stats == {"hits": 0, "misses": 0, "invalidations": 0} and n_cached == 0
            assert fetches >= 2
        else:
            # the grounded entry hits; the re-seeded one misses and runs
            # its round and the exact program again
            assert stats["hits"] == 1 and n_cached == 1 and fetches == 2
        # the single-query path consults the cache only when asked to
        got = {}
        for das, pkg in ((jx, JX), (pt, PT)):
            m, comp, fz = pkg[1], pkg[2], pkg[3]
            plans = comp.plan_query(das.db, grounded(m, names[50]))
            ex = fz.get_executor(das.db)
            f0 = fz.FETCH_COUNTS["n"]
            first = ex.execute(plans, use_cache=True)
            second = ex.execute(plans, use_cache=True)
            third = ex.execute(plans)
            got[pkg[0]] = (fz.FETCH_COUNTS["n"] - f0, second is first, third is first,
                           first.count, _cache_stats(das, pkg))
        assert got["jx"] == got["pt"]
        assert got["pt"][1:3] == ((False, False) if size == 0 else (True, False))


def test_count_matches_none_where_das_tpu_declines():
    """count_matches returns None wherever das_tpu's tree executor
    declines, in the port too: under assignment.CONFIG["no_overload"], and
    where the tree planner raises NotCompilable (an ordered pattern on the
    unordered Similarity type)."""
    jx = JxDAS(backend="tensor", data=jx_load(jx_animals()),
               config=JxConfig(use_planner="off", use_multiway="off"))
    pt = DistributedAtomSpace(backend="tensor", device="cpu",
                              data=load_metta_text(animals_metta()))

    def chain(m):
        V = m.Variable
        return m.And([m.Link("Inheritance", [V("V1"), V("V2")], True),
                      m.Link("Inheritance", [V("V2"), V("V3")], True)])

    def either_kind(m):
        return m.Or([m.Link("Inheritance", [m.Variable("V1"), m.Variable("V2")], True),
                     chain(m)])

    flags = (jx_assignment.CONFIG.get("no_overload"), assignment.CONFIG.get("no_overload"))
    try:
        for on, want in ((True, None), (False, 7)):
            jx_assignment.CONFIG["no_overload"] = on
            assignment.CONFIG["no_overload"] = on
            assert jx_compiler.count_matches(jx.db, chain(jx_ast)) == want
            assert compiler.count_matches(pt.db, chain(ast)) == want
        assert jx_compiler.count_matches(jx.db, either_kind(jx_ast)) == 19
        assert compiler.count_matches(pt.db, either_kind(ast)) == 19

        def ordered_similarity(m):
            V = m.Variable
            return m.Or([m.Link("Inheritance", [V("V1"), V("V2")], True),
                         m.Link("Similarity", [V("V1"), V("V2")], True)])

        assert jx_compiler.count_matches(jx.db, ordered_similarity(jx_ast)) is None
        assert compiler.count_matches(pt.db, ordered_similarity(ast)) is None
    finally:
        jx_assignment.CONFIG["no_overload"], assignment.CONFIG["no_overload"] = flags
