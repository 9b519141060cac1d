"""Whole-tree fusion in the port (das_tpu_torch/query/fused.py
`build_fused_tree`, `_TreeExecJob`; query/tree.py `query_tree_fused`;
device="cpu") against the JAX package's (das_tpu, JAX on the CPU): the
single-device pins of tests/test_ztreefuse.py.

  * on the bio Or/negation suite, with use_tree_fusion "on" and "off" in
    both packages: the same answers, and the same tree / fused_tree / host
    routes per query; "on" and "off" give the same answers; the tree job's
    stats vector and result table are bit-equal to das_tpu's;
  * a 3-branch Or runs as ONE tree job with one host fetch, where the
    staged tree pays one fetch per site (and one to cache its tables);
  * unordered and heterogeneous shapes fall back to the staged tree with
    no fused_tree answer;
  * a repeated query is a cache hit with no device work and no fetch, and
    a commit invalidates it;
  * a declined fused attempt is memoized for the delta version;
  * FusedTreeSig's fields are part of its identity."""

import dataclasses

import numpy as np
import pytest

from das_tpu import planner as jx_planner
from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query import fused as jx_fused
from das_tpu.query import plan as jx_plan
from das_tpu.query import tree as jx_tree
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch import planner
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query import fused
from das_tpu_torch.query import plan
from das_tpu_torch.query import tree
from das_tpu_torch.query.fused import FusedPlanSig, FusedTreeSig
from das_tpu_torch.storage.atom_table import load_metta_text
from tests.test_differential import canon

#: tests/test_ztreefuse.py's KB
KB = dict(n_genes=60, n_processes=15, members_per_gene=4, n_interactions=80, seed=7)

ROUTES = ("fused", "staged", "tree", "fused_tree", "fused_multiway", "host")


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    monkeypatch.delenv("DAS_TPU_TREE_FUSION", raising=False)
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_STAR"):
        monkeypatch.delenv(var, raising=False)


def _bio_pair(mode):
    jdata, _, _ = jx_bio(**KB)
    pdata, _, _ = build_bio_atomspace(**KB)
    jx = JxDAS(backend="tensor", data=jdata, config=JxConfig(use_tree_fusion=mode))
    pt = DistributedAtomSpace(backend="tensor", data=pdata, device="cpu",
                              config=DasConfig(use_tree_fusion=mode))
    names = pt.db.get_all_nodes("Gene", names=True)[:3]
    assert names == jx.db.get_all_nodes("Gene", names=True)[:3]
    return jx, pt, names


@pytest.fixture(scope="module")
def bio_on():
    return _bio_pair("on")


@pytest.fixture(scope="module")
def bio_off():
    return _bio_pair("off")


def _branch(m, gene):
    return m.And([m.Link("Member", [m.Node("Gene", gene), m.Variable("V3")], True),
                  m.Link("Member", [m.Variable("V2"), m.Variable("V3")], True)])


def _suite(m, n):
    L, V, N = m.Link, m.Variable, m.Node
    return [
        # plain 2-branch union
        m.Or([_branch(m, n[0]), _branch(m, n[2])]),
        # 3-branch union
        m.Or([_branch(m, g) for g in n]),
        # single-term branches sharing the universe with a conjunction
        m.Or([_branch(m, n[0]),
              m.And([L("Member", [N("Gene", n[1]), V("V3")], True),
                     L("Member", [V("V2"), V("V3")], True)])]),
        # the de-Morgan difference branch (joint negative minus union)
        m.Or([_branch(m, n[0]), m.Not(_branch(m, n[1]))]),
        m.Or([_branch(m, n[0]), _branch(m, n[2]), m.Not(_branch(m, n[1]))]),
        # nested positive Or flattens into the same union
        m.Or([_branch(m, n[0]), m.Or([_branch(m, n[1]), _branch(m, n[2])])]),
        # in-branch negated term (anti join inside one site)
        m.Or([_branch(m, n[0]),
              m.And([L("Member", [N("Gene", n[1]), V("V3")], True),
                     L("Member", [V("V2"), V("V3")], True),
                     m.Not(L("Interacts", [N("Gene", n[1]), V("V2")], True))])]),
    ]


def _answer_set(answer):
    return {canon(a) for a in answer.assignments}


def _routed(das, comp, q):
    """(matched, answer, route deltas) of one query_answer."""
    r0 = dict(comp.ROUTE_COUNTS)
    m, a = das.query_answer(q)
    return m, a, {k: comp.ROUTE_COUNTS[k] - r0[k] for k in ROUTES}


@pytest.mark.parametrize("i", range(7))
@pytest.mark.parametrize("mode", ["on", "off"])
def test_tree_routes_and_answers_match_das_tpu(bio_on, bio_off, mode, i):
    jx, pt, names = bio_on if mode == "on" else bio_off
    jm, ja, jr = _routed(jx, jx_compiler, _suite(jx_ast, names)[i])
    pm, pa, pr = _routed(pt, compiler, _suite(ast, names)[i])
    assert pr == jr and pr["host"] == 0 and pr["tree"] == 1
    assert pr["fused_tree"] == (1 if mode == "on" else 0)
    assert pm == jm and pa.negation == ja.negation and _answer_set(pa) == _answer_set(ja)
    # fusion on and off give the same answers
    other = bio_off if mode == "on" else bio_on
    om, oa = other[1].query_answer(_suite(ast, names)[i])
    assert om == pm and oa.assignments == pa.assignments and oa.negation == pa.negation


def _tree_job(m, fz, pl, tr, das, q):
    node = pl.build_plan(das.db, q)
    pos_sites, neg_plans, _const = tr.tree_fusion_sites(node)
    return fz.get_executor(das.db).execute_tree(pos_sites, neg_plans)


@pytest.mark.parametrize("i", range(7))
def test_tree_job_tables_bit_equal(bio_on, i):
    """The tree job's stats vector ([final_count, *site blocks, *neg block])
    and its result table (valid mask, values of the valid rows, column
    names) equal das_tpu's."""
    jx, pt, names = bio_on
    jj = _tree_job(jx_ast, jx_fused, jx_plan, jx_tree, jx, _suite(jx_ast, names)[i])
    pj = _tree_job(ast, fused, plan, tree, pt, _suite(ast, names)[i])
    assert pj.result is not None and jj.result is not None
    assert pj.result.var_names == jj.result.var_names
    jv, jm = np.asarray(jj.result.host_vals), np.asarray(jj.result.host_valid)
    assert pj.result.host_valid.tolist() == jm.tolist()
    assert pj.result.host_vals[pj.result.host_valid].tolist() == jv[jm].tolist()
    assert pj.rounds == jj.rounds and pj.matched_any == jj.matched_any
    assert pj.result.count == int(pj.result.host_valid.sum())
    # the settled round again, for its stats vector (das_tpu's result does
    # not keep it)
    (_jv, _jm, jstats), (_pv, _pm, pstats) = jj.dispatch(), pj.dispatch()
    assert pstats.tolist() == [int(x) for x in np.asarray(jstats)]
    assert int(pstats[0]) == pj.result.count


def _device_work(monkeypatch):
    """Count conjunction runs (every device program of the fused paths)."""
    calls = {"n": 0}
    orig = fused.run_conj

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(fused, "run_conj", counted)
    return calls


def test_three_branch_or_one_tree_job():
    """ONE tree job and one host fetch with fusion on; the staged tree pays
    one fetch per site and one to cache its tables; the planner's program
    counts and the fetches equal das_tpu's in both arms."""
    got = {}
    for mode in ("off", "on"):
        jx, pt, names = _bio_pair(mode)
        deltas = []
        for das, m, fz, pl, comp in ((jx, jx_ast, jx_fused, jx_planner, jx_compiler),
                                     (pt, ast, fused, planner, compiler)):
            q = m.Or([_branch(m, g) for g in names])
            f0, p0 = fz.FETCH_COUNTS["n"], pl.PLANNER_COUNTS["programs"]
            r0 = dict(comp.ROUTE_COUNTS)
            matched, answer = das.query_answer(q)
            deltas.append((fz.FETCH_COUNTS["n"] - f0, pl.PLANNER_COUNTS["programs"] - p0,
                           comp.ROUTE_COUNTS["fused_tree"] - r0["fused_tree"],
                           comp.ROUTE_COUNTS["fused_multiway"] - r0["fused_multiway"],
                           _answer_set(answer)))
        assert deltas[0] == deltas[1], mode
        got[mode] = deltas[1]
    assert got["on"][:4] == (1, 1, 1, 0)
    assert got["off"][0] == 4 and got["off"][1] >= 3 and got["off"][2] == 0
    assert got["on"][4] == got["off"][4]


def test_unordered_and_heterogeneous_shapes_fall_back(monkeypatch):
    jx = JxDAS(backend="tensor", data=jx_load(jx_animals()),
               config=JxConfig(use_tree_fusion="on"))
    pt = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                              device="cpu", config=DasConfig(use_tree_fusion="on"))
    off = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                               device="cpu", config=DasConfig(use_tree_fusion="off"))

    def unordered(m):
        L, V, N = m.Link, m.Variable, m.Node
        return m.Or([m.And([L("Inheritance", [N("Concept", "human"), V("V1")], True),
                            L("Inheritance", [V("V2"), V("V1")], True)]),
                     L("Similarity", [N("Concept", "human"), V("V1")], False)])

    def heterogeneous(m):
        L, V, N = m.Link, m.Variable, m.Node
        return m.Or([L("Inheritance", [V("V1"), N("Concept", "mammal")], True),
                     m.And([L("Inheritance", [V("V2"), V("V3")], True),
                            L("Inheritance", [V("V3"), N("Concept", "animal")], True)])])

    for build in (unordered, heterogeneous):
        jm, ja, jr = _routed(jx, jx_compiler, build(jx_ast))
        pm, pa, pr = _routed(pt, compiler, build(ast))
        assert pr == jr and pr["fused_tree"] == 0 and pr["tree"] == 1
        om, oa = off.query_answer(build(ast))
        assert pm == jm == om and _answer_set(pa) == _answer_set(ja) == _answer_set(oa)
        assert pa.assignments
    # neither shape is in the fusable subset
    for build in (unordered, heterogeneous):
        assert tree.tree_fusion_sites(plan.build_plan(pt.db, build(ast))) is None


def test_tree_fused_cache_hit_and_commit_invalidation(monkeypatch):
    jx, pt, names = _bio_pair("on")
    q = ast.Or([_branch(ast, names[0]), ast.Not(_branch(ast, names[1]))])
    _m1, a1 = pt.query_answer(q)
    calls = _device_work(monkeypatch)
    f0, r0 = fused.FETCH_COUNTS["n"], compiler.ROUTE_COUNTS["fused_tree"]
    _m2, a2 = pt.query_answer(q)
    assert calls["n"] == 0 and fused.FETCH_COUNTS["n"] == f0, "a hit does no device work"
    assert compiler.ROUTE_COUNTS["fused_tree"] == r0
    assert a2.assignments == a1.assignments and a2.negation == a1.negation
    stats = fused.result_cache_stats(pt.db)
    assert stats["hits"] >= 1

    # a commit bumps delta_version: the entry is stale and the next query
    # runs the tree job again, on the committed store
    procs = pt.db.get_all_nodes("BiologicalProcess", names=True)[:1]
    text = ('(: "GENE:ZTF" Gene)\n' + f'(: "{procs[0]}" BiologicalProcess)\n'
            + f'(Member "GENE:ZTF" "{procs[0]}")\n')
    pt.load_metta_text(text)
    jx.load_metta_text(text)
    _m3, a3 = pt.query_answer(q)
    assert calls["n"] >= 2 and compiler.ROUTE_COUNTS["fused_tree"] == r0 + 1
    assert fused.result_cache_stats(pt.db)["invalidations"] > stats["invalidations"]
    jq = jx_ast.Or([_branch(jx_ast, names[0]), jx_ast.Not(_branch(jx_ast, names[1]))])
    _m4, a4 = jx.query_answer(jq)
    assert _answer_set(a3) == _answer_set(a4)


def test_declined_fused_tree_memoized(monkeypatch):
    """A declined fused attempt is memoized in `tree_results` for the delta
    version: the repeat goes straight to the staged tree, whose own cache
    answers with no device work."""
    _jx, pt, names = _bio_pair("on")
    _jx2, off, _ = _bio_pair("off")
    q = ast.Or([_branch(ast, g) for g in names])
    ex = fused.get_executor(pt.db)
    declines = {"n": 0}

    def declining(pos_sites, neg_plans=None):
        declines["n"] += 1
        return None

    monkeypatch.setattr(ex, "execute_tree", declining)
    m1, a1 = pt.query_answer(q)   # fused declines: the staged tree answers
    calls = _device_work(monkeypatch)
    f0 = fused.FETCH_COUNTS["n"]
    m2, a2 = pt.query_answer(q)   # memoized decline + staged cache hit
    assert declines["n"] == 1, "the decline must be memoized per delta version"
    assert calls["n"] == 0 and fused.FETCH_COUNTS["n"] == f0
    assert m1 == m2 and a1.assignments == a2.assignments
    _m3, a3 = off.query_answer(q)
    assert a1.assignments == a3.assignments


def test_tree_sig_field_distinctness():
    site_a = FusedPlanSig((), (16,), ())
    site_b = FusedPlanSig((), (32,), ())
    assert FusedTreeSig((site_a,)) != FusedTreeSig((site_b,))
    # a negative site is part of the key: union-only and difference jobs
    # for the same positive sites must cache side by side
    assert FusedTreeSig((site_a,), None) != FusedTreeSig((site_a,), site_b)
    assert hash(FusedTreeSig((site_a,), None)) != hash(FusedTreeSig((site_a,), site_b))
    assert [f.name for f in dataclasses.fields(FusedTreeSig)] == ["sites", "neg"]
    with pytest.raises(dataclasses.FrozenInstanceError):
        FusedTreeSig((site_a,)).sites = ()
