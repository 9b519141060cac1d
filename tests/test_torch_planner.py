"""The port's cost planner against the JAX package's on the same store.

`plan_conjunction` of both packages gives identical `PlannedProgram`s —
order, estimated term and step rows, capacity seeds, route, search method,
cost and multiway prefix — on a query family that covers the reference
order, the DP, the greedy tail, the multiway routes and a declined
(disconnected) conjunction, under use_multiway "auto", "on" and "off".
The planner counters agree after the same executions, and the k-way
statistic equals a brute-force count."""

from collections import Counter
from dataclasses import asdict

import pytest

from das_tpu import planner as jx_planner
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query.fused import get_executor as jx_executor
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch import planner
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.ops.counters import PLANNER_KEYS, ROUTE_KEYS
from das_tpu_torch.planner import search
from das_tpu_torch.planner.stats import estimator_for
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query.fused import get_executor
from das_tpu_torch.storage.atom_table import host_segments
from das_tpu_torch.storage.tensor_db import TensorDB

KB = dict(n_genes=2000, n_processes=200, members_per_gene=5, n_interactions=1500,
          n_evaluations=0, seed=3)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    # the config decides; learned capacities stay in this process
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PLANNER_DP_MAX",
                "DAS_TPU_PALLAS", "DAS_TPU_VMEM_BUDGET", "DAS_TPU_STAR"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def kb():
    jdata, genes, procs = jx_bio(**KB)
    pdata, _, _ = build_bio_atomspace(**KB)
    genes = [jdata.nodes[h].name for h in genes]
    procs = [jdata.nodes[h].name for h in procs]
    return jdata, pdata, genes, procs, _partner_procs(pdata, genes)


def _family(mod, genes, procs, partner_procs):
    """name -> query: the grounded 3-clause query and its Not variant, the
    triangle, the grounded and fan-out stars, the co-member star, a
    disconnected pair and a 9-clause chain."""
    L, V, N = mod.Link, mod.Variable, mod.Node
    g, h = genes[0], genes[1]
    p1, p2 = partner_procs

    def grounded(negate):
        third = L("Interacts", [N("Gene", g), V("V2")], True)
        return mod.And([L("Member", [N("Gene", g), V("V3")], True),
                        L("Member", [V("V2"), V("V3")], True),
                        mod.Not(third) if negate else third])

    return {
        "grounded": grounded(False),
        "grounded_not": grounded(True),
        "triangle": mod.And([L("Member", [V("V1"), V("V3")], True),
                             L("Member", [V("V2"), V("V3")], True),
                             L("Interacts", [V("V1"), V("V2")], True)]),
        "grounded_star": mod.And([L("Member", [V("V1"), N("BiologicalProcess", p1)], True),
                                  L("Member", [V("V1"), N("BiologicalProcess", p2)], True),
                                  L("Interacts", [N("Gene", g), V("V1")], True)]),
        "fanout_star": mod.And([L("Member", [V("V1"), N("BiologicalProcess", procs[0])], True),
                                L("Member", [V("V1"), V("P2")], True),
                                L("Interacts", [V("V1"), V("V2")], True)]),
        "comember_star": mod.And([L("Member", [N("Gene", g), V("V3")], True),
                                  L("Member", [V("V2"), V("V3")], True),
                                  L("Member", [V("V4"), V("V3")], True)]),
        "disconnected": mod.And([L("Member", [N("Gene", g), V("V1")], True),
                                 L("Member", [N("Gene", h), V("V2")], True)]),
        "chain9": mod.And([L("Interacts", [V(f"C{i}"), V(f"C{i + 1}")], True)
                           for i in range(9)]),
    }


def _partner_procs(data, genes):
    """Two processes of one interaction partner of genes[0] (the grounded
    star's answer is then non-empty)."""
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu")
    L, V, N = ast.Link, ast.Variable, ast.Node
    _ok, partners = das.query_answer(L("Interacts", [N("Gene", genes[0]), V("X")], True))
    for x in sorted(a.mapping["X"] for a in partners.assignments):
        _ok, ps = das.query_answer(L("Member", [N("Gene", data.nodes[x].name), V("P")], True))
        names = sorted(data.nodes[a.mapping["P"]].name for a in ps.assignments)
        if len(names) >= 2:
            return names[0], names[1]
    raise AssertionError("no interaction partner with two processes")


def _plans(jdb, pdb, genes, procs, partner, name):
    jq = _family(jx_ast, genes, procs, partner)[name]
    pq = _family(ast, genes, procs, partner)[name]
    return jx_compiler.plan_query(jdb, jq), compiler.plan_query(pdb, pq)


NAMES = ["grounded", "grounded_not", "triangle", "grounded_star", "fanout_star",
         "comember_star", "disconnected", "chain9"]


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_plan_conjunction_matches_das_tpu(kb, mode):
    jdata, pdata, genes, procs, partner = kb
    jdb = JxTensorDB(jdata, JxConfig(use_multiway=mode))
    pdb = TensorDB(pdata, DasConfig(use_multiway=mode), device="cpu")
    methods = Counter()
    for name in NAMES:
        jplans, pplans = _plans(jdb, pdb, genes, procs, partner, name)
        want = jx_planner.plan_conjunction(jdb, jplans)
        got = planner.plan_conjunction(pdb, pplans)
        assert (want is None) == (got is None), name
        if want is None:
            methods["declined"] += 1
            continue
        assert asdict(got) == asdict(want), name
        assert got.route in ROUTE_KEYS
        methods[got.method] += 1
        if mode == "auto" and name in ("grounded_star", "fanout_star"):
            assert got.multiway == 3 and got.route == "fused_multiway", name
        if mode == "auto" and name in ("comember_star", "grounded"):
            assert got.multiway == 0, name
        if mode == "off":
            assert got.multiway == 0
    assert methods == {"ref_order": 5, "dp": 1, "greedy_tail": 1, "declined": 1}


def test_dp_ceiling_matches_das_tpu(kb, monkeypatch):
    """A DP ceiling of 2 sends the triangle to the greedy tail in both
    packages (das_tpu reads it from DAS_TPU_PLANNER_DP_MAX, the port's is
    the constant search.DEFAULT_DP_MAX)."""
    jdata, pdata, genes, procs, partner = kb
    monkeypatch.setenv("DAS_TPU_PLANNER_DP_MAX", "2")
    monkeypatch.setattr(search, "DEFAULT_DP_MAX", 2)
    jdb = JxTensorDB(jdata, JxConfig())
    pdb = TensorDB(pdata, DasConfig(), device="cpu")
    jplans, pplans = _plans(jdb, pdb, genes, procs, partner, "triangle")
    got = planner.plan_conjunction(pdb, pplans)
    assert asdict(got) == asdict(jx_planner.plan_conjunction(jdb, jplans))
    assert got.method == "greedy_tail"


def test_planner_counts_match_das_tpu(kb):
    jdata, pdata, genes, procs, partner = kb
    jdb = JxTensorDB(jdata, JxConfig())
    pdb = TensorDB(pdata, DasConfig(), device="cpu")
    jx_planner.reset_planner_counts()
    planner.reset_planner_counts()
    compiler.reset_route_counts()
    for name in NAMES[:-1]:    # the 9-clause chain is planned, not run
        jplans, pplans = _plans(jdb, pdb, genes, procs, partner, name)
        want = jx_executor(jdb).execute(jplans, count_only=True)
        got = get_executor(pdb).execute(pplans, count_only=True)
        assert (got.count, got.reseed_needed, got.multiway) == (
            want.count, want.reseed_needed, want.multiway), name
    assert set(planner.PLANNER_COUNTS) == set(PLANNER_KEYS)
    assert planner.PLANNER_COUNTS == {k: jx_planner.PLANNER_COUNTS[k] for k in PLANNER_KEYS}
    assert planner.snapshot() == jx_planner.snapshot()
    assert planner.PLANNER_COUNTS["greedy"] == 1 and planner.PLANNER_COUNTS["planned"] == 6
    assert compiler.ROUTE_COUNTS["fused_multiway"] == 2


def test_multiway_rows_exact_vs_brute_force(kb):
    pdata = kb[1]
    pdb = TensorDB(pdata, DasConfig(), device="cpu")
    star = ast.And([ast.Link("Member", [ast.Variable(v), ast.Variable("V3")], True)
                    for v in ("V1", "V2", "V4")])
    plans = compiler.plan_query(pdb, star)
    est = estimator_for(pdb)
    rows, exact = est.multiway_rows(plans, "V3")
    assert exact
    deg = Counter()
    tid = plans[0].type_id
    for b in host_segments(pdb, 2):
        sel = b.targets[: b.size][b.type_id[: b.size] == tid]
        deg.update(sel[:, 1].tolist())
    assert int(rows) == sum(d ** 3 for d in deg.values())
    assert est.multiway_rows(plans, "V3") == (rows, True)   # memoized
    # a commit moves the delta_version: the next estimator is a new one
    assert estimator_for(pdb) is est
    pdb.delta_version += 1
    assert estimator_for(pdb) is not est
