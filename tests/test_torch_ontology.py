"""The port's ontology generator (das_tpu_torch/models/bio.py
build_bio_ontology_atomspace) and the reference benchmark's three query
layouts (scripts/benchmark.py) against das_tpu.

  * the generator's records equal das_tpu's: handles, named types, link
    tuples and their order;
  * the port's TensorDB tables are bit-equal to das_tpu's;
  * QUERY_1 (an N-way And of grounded Member links), QUERY_2 (a nested
    And/Or with Inheritance LinkTemplates) and QUERY_3 (the substring ->
    List -> Member pipeline) give das_tpu's answers, as sets, through the
    facades' `_dispatch_query` on the tensor backend and on the sharded
    backend (8 shards), for a few seeded gene samples, with the same route
    counters.

das_tpu's mesh tree executor takes ~40 s a QUERY_2 on the CPU, so its
sharded store answers trees on its host algebra here
(`sharded_tree_fallback="host"`); QUERY_2's answers are held against
das_tpu's fused tree on the tensor backend too.  For the same reason the
port's sharded QUERY_3 is held against das_tpu's tensor store
(`layout_runs`)."""

import random

import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.bio import build_bio_ontology_atomspace as jx_onto
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.bio import build_bio_ontology_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.storage.tensor_db import TensorDB
from tests.test_differential import canon
from tests.test_torch_store import _assert_tables_equal, _jx_tables

SIZE = dict(n_genes=40, n_processes=12, members_per_gene=3, n_interactions=40,
            n_reactomes=20, n_uniprots=30, seed=3)
S = 8
SAMPLES = 3


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_STAR",
                "DAS_TPU_TREE_FUSION", "DAS_TPU_VMEM_BUDGET", "DAS_TPU_PLANNER_DP_MAX"):
        monkeypatch.delenv(var, raising=False)


# -- the reference benchmark's layouts, for either package (`m` is its ast) --


def same_biological_process(m, gene_names):
    v1 = m.Variable("V_BiologicalProcess")
    return m.And([m.Link("Member", [m.Node("Gene", g), v1], True) for g in gene_names])


def same_or_inherited_biological_process(m, gene_names):
    v1 = m.Variable("V1_BiologicalProcess")
    v2 = m.Variable("V2_BiologicalProcess")
    tv1 = m.TypedVariable("V1_BiologicalProcess", "BiologicalProcess")
    tv2 = m.TypedVariable("V2_BiologicalProcess", "BiologicalProcess")
    tv3 = m.TypedVariable("V3_BiologicalProcess", "BiologicalProcess")
    g1, g2 = gene_names[0], gene_names[1]
    return m.And([
        m.Link("Member", [m.Node("Gene", g1), v1], True),
        m.Or([
            m.And([m.Link("Member", [m.Node("Gene", g2), v2], True),
                   m.LinkTemplate("Inheritance", [tv2, tv3], True),
                   m.LinkTemplate("Inheritance", [tv1, tv3], True)]),
            m.Link("Member", [m.Node("Gene", g2), v1], True),
        ]),
    ])


def _answer(m, das, query):
    a = m.PatternMatchingAnswer()
    matched = das._dispatch_query(query, a)
    return bool(matched), frozenset(canon(x) for x in a.assignments)


def coa_pipeline(m, das, gene_names):
    """QUERY_3: the Concepts whose name holds "CoA", their Reactomes
    through List, those Reactomes' Uniprots through Member, then each
    Uniprot's processes shared with every sampled gene.  Returns every
    stage's answers."""
    db = das.db
    v1 = m.Variable("v1")
    member_links = [m.Link("Member", [m.Node("Gene", g), v1], True) for g in gene_names]
    stages = []
    reactomes = []
    for handle in sorted(db.get_matched_node_name("Concept", "CoA")):
        a = m.PatternMatchingAnswer()
        q = m.Link("List", [v1, m.Node("Concept", db.get_node_name(handle))], True)
        if das._dispatch_query(q, a):
            reactomes += sorted(x.mapping["v1"] for x in a.assignments)
        stages.append(frozenset(canon(x) for x in a.assignments))
    uniprots = []
    for r in reactomes:
        a = m.PatternMatchingAnswer()
        q = m.Link("Member", [v1, m.Node("Reactome", db.get_node_name(r))], True)
        if das._dispatch_query(q, a):
            uniprots += sorted(x.mapping["v1"] for x in a.assignments)
        stages.append(frozenset(canon(x) for x in a.assignments))
    for u in uniprots:
        q = m.And([*member_links,
                   m.Link("Member", [m.Node("Uniprot", db.get_node_name(u)), v1], True)])
        stages.append(_answer(m, das, q))
    return stages


def _samples(das):
    names = sorted(das.db.get_all_nodes("Gene", names=True))
    rng = random.Random(11)
    return [rng.sample(names, 2) for _ in range(SAMPLES)]


def _run_layouts(m, comp, das, layouts):
    comp.reset_route_counts()
    out = {}
    for i, genes in enumerate(_samples(das)):
        if 1 in layouts:
            out[(1, i)] = _answer(m, das, same_biological_process(m, genes))
        if 2 in layouts:
            out[(2, i)] = _answer(m, das, same_or_inherited_biological_process(m, genes))
        if 3 in layouts:
            out[(3, i)] = coa_pipeline(m, das, genes)
    return out, {k: v for k, v in comp.ROUTE_COUNTS.items() if v}


@pytest.fixture(scope="module")
def ontologies():
    return jx_onto(**SIZE), build_bio_ontology_atomspace(**SIZE)


# -- the generator -----------------------------------------------------------


def test_records_equal_das_tpu(ontologies):
    (jdata, jgenes, jprocs), (pdata, pgenes, pprocs) = ontologies
    assert (pgenes, pprocs) == (jgenes, jprocs)
    for field in ("nodes", "links", "typedefs"):
        mine, theirs = getattr(pdata, field), getattr(jdata, field)
        assert list(mine) == list(theirs), field   # handles and their order
        assert [vars(r) for r in mine.values()] == [vars(r) for r in theirs.values()], field
    assert dict(pdata.table.named_types) == dict(jdata.table.named_types)
    names = {n.name for n in pdata.nodes.values() if n.named_type == "Concept"}
    assert sum("CoA" in n for n in names) == 2   # every 10th of 20 pathways


def test_tensor_tables_equal_das_tpu(ontologies):
    (jdata, _, _), (pdata, _, _) = ontologies
    _assert_tables_equal(_jx_tables(JxTensorDB(jdata, JxConfig())),
                         TensorDB(pdata, device="cpu").dev)


# -- the three layouts --------------------------------------------------------


def _facades(backend):
    jdata, _, _ = jx_onto(**SIZE)
    pdata, _, _ = build_bio_ontology_atomspace(**SIZE)
    if backend == "tensor":
        return (JxDAS(backend="tensor", data=jdata),
                DistributedAtomSpace(backend="tensor", data=pdata, device="cpu"))
    return (JxDAS(backend="sharded", data=jdata,
                  config=JxConfig(backend="sharded", sharded_tree_fallback="host")),
            DistributedAtomSpace(backend="sharded", data=pdata, device="cpu",
                                 config=DasConfig(mesh_shape=(S,))))


@pytest.fixture(scope="module")
def layout_runs():
    """{(package, backend): (answers, routes)}.  das_tpu's sharded store
    runs QUERY_1 and QUERY_2 only: its mesh program for QUERY_3's 3-term
    And takes 25-35 s to compile on the CPU, so the port's sharded QUERY_3
    is held against das_tpu's tensor store (the same records)."""
    runs = {}
    for backend in ("tensor", "sharded"):
        jx, pt = _facades(backend)
        assert pt.db.__class__.__name__ == jx.db.__class__.__name__
        if backend == "sharded":
            assert pt.db.mesh.size == jx.db.mesh.size == S
        runs[("das_tpu", backend)] = _run_layouts(jx_ast, jx_compiler, jx,
                                                  (1, 2) if backend == "sharded" else (1, 2, 3))
        runs[("port", backend)] = _run_layouts(ast, compiler, pt, (1, 2, 3))
    return runs


@pytest.mark.parametrize("backend", ["tensor", "sharded"])
@pytest.mark.parametrize("layout", [1, 2, 3])
def test_layout_answers_equal_das_tpu(layout_runs, backend, layout):
    want = layout_runs[("das_tpu", "tensor" if (backend, layout) == ("sharded", 3)
                        else backend)][0]
    got = layout_runs[("port", backend)][0]
    keys = [k for k in want if k[0] == layout]
    assert len(keys) == SAMPLES
    for k in keys:
        assert got[k] == want[k], k
    if layout == 3:
        # the pipeline reaches its last stage with answers
        assert any(st[-1][1] for st in (got[k] for k in keys) if st)
    else:
        assert any(got[k][0] for k in keys)


def test_layout_routes_equal_das_tpu(layout_runs):
    jt, pt = layout_runs[("das_tpu", "tensor")][1], layout_runs[("port", "tensor")][1]
    assert pt == jt and pt["fused"] > 0 and pt["tree"] == SAMPLES
    js, ps = layout_runs[("das_tpu", "sharded")][1], layout_runs[("port", "sharded")][1]
    # every query on the mesh, QUERY_2's tree included; das_tpu answers
    # QUERY_2 on its host algebra here (module docstring)
    assert ps["sharded"] == sum(v for k, v in pt.items() if k in ("fused", "tree"))
    assert ps.get("sharded_multiway", 0) == pt.get("fused_multiway", 0)
    assert (js["sharded"], js["host"]) == (SAMPLES, SAMPLES)
