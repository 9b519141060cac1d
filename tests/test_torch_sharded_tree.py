"""The tree executor on the port's mesh (das_tpu_torch/parallel/
sharded_tree.py ShardedTreeOps, query/tree.py with the `tree_ops` hook;
fused_sharded.py's whole-tree job; 8 shards on device="cpu") against
das_tpu's on 8 virtual CPU devices:

  * every table of the staged tree bit for bit, as row-sharded
    [S*cap, k] tables (an Or of heterogeneous conjunctions, unordered
    links, the de-Morgan difference), and the answers as sets against the
    host algebra (those and Not of an unordered term, nesting, an
    unordered join);
  * the whole-tree mesh job's stats vector and per-shard table bit for
    bit, its route counter, and the fused and staged answers equal."""

import numpy as np
import pytest

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.parallel import fused_sharded as jx_fs
from das_tpu.parallel.mesh import make_mesh as jx_make_mesh
from das_tpu.parallel.sharded_db import ShardedDB as JxShardedDB
from das_tpu.query import ast as jx_ast
from das_tpu.query import plan as jx_plan
from das_tpu.query import tree as jx_tree
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.parallel import fused_sharded as fs
from das_tpu_torch.parallel.sharded_db import ShardedDB
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query import fused
from das_tpu_torch.query import plan
from das_tpu_torch.query import tree
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.memory_db import MemoryDB
from tests.test_differential import canon

S = 8
BIO = dict(n_genes=40, n_processes=10, members_per_gene=3, n_interactions=50, seed=5)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_TREE_FUSION"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def animals():
    return (JxShardedDB(jx_load(jx_animals()), JxConfig(), mesh=jx_make_mesh(S)),
            ShardedDB(load_metta_text(animals_metta()), DasConfig(mesh_shape=(S,)),
                      device="cpu"))


def _trees(m):
    L, V, N = m.Link, m.Variable, m.Node
    inh = lambda a, b: L("Inheritance", [a, b], True)  # noqa: E731
    return [
        # Or of conjunctions over different variable sets (staged union)
        m.Or([m.And([inh(V("V1"), V("V2")), inh(V("V2"), N("Concept", "animal"))]),
              inh(V("V1"), N("Concept", "mammal"))]),
        # unordered links
        L("Similarity", [V("V1"), N("Concept", "human")], False),
        m.And([L("Similarity", [V("V1"), V("V2")], False), inh(V("V1"), V("V3"))]),
        # Not of an unordered term inside an And
        m.And([inh(V("V1"), V("V2")),
               m.Not(L("Similarity", [V("V1"), N("Concept", "human")], False))]),
        # nesting: an Or inside an And
        m.And([m.Or([inh(V("V1"), N("Concept", "mammal")),
                     inh(V("V1"), N("Concept", "reptile"))]),
               inh(V("V1"), V("V2"))]),
        # the de-Morgan difference
        m.Or([inh(V("V1"), N("Concept", "mammal")),
              m.Not(m.And([inh(V("V1"), V("V2")), inh(V("V2"), N("Concept", "animal"))]))]),
    ]


def _table_key(t):
    return (t.kind, tuple(t.onames), tuple(t.ocols), tuple(t.ugroups), t.count)


#: the trees whose tables are held against das_tpu's (its mesh tree
#: executor takes 5-10 s a query here; the nested and Not-of-unordered
#: shapes take 20-40 s, and their answers are held against the host below)
TABLE_TREES = (0, 1, 5)


@pytest.mark.parametrize("qi", TABLE_TREES)
def test_tree_tables_equal_das_tpu(animals, qi):
    jdb, pdb = animals
    jq, pq = _trees(jx_ast)[qi], _trees(ast)[qi]
    jr = jx_tree.eval_plan(jdb, jx_plan.build_plan(jdb, jq))
    pr = tree.eval_plan(pdb, plan.build_plan(pdb, pq))
    assert (pr.negation, pr.matched) == (jr.negation, jr.matched)
    assert [_table_key(t) for t in pr.tables] == [_table_key(t) for t in jr.tables]
    for jt, pt in zip(jr.tables, pr.tables):
        assert np.array_equal(pt.vals.numpy(), np.asarray(jt.vals))
        assert np.array_equal(pt.valid.numpy(), np.asarray(jt.valid))
        assert pt.vals.shape[0] % S == 0


@pytest.mark.parametrize("qi", range(len(_trees(ast))))
def test_tree_answers_equal_host(animals, qi):
    _jdb, pdb = animals
    pq = _trees(ast)[qi]
    host = ast.PatternMatchingAnswer()
    host_matched = pq.matched(MemoryDB(pdb.data), host)
    compiler.reset_route_counts()
    got = ast.PatternMatchingAnswer()
    matched = compiler.dispatch(pdb, pq, got)
    assert compiler.ROUTE_COUNTS["sharded"] == 1 and compiler.ROUTE_COUNTS["host"] == 0
    assert (bool(matched), got.negation) == (bool(host_matched), host.negation)
    assert {canon(a) for a in got.assignments} == {canon(a) for a in host.assignments}


def _branch(m, gene):
    return m.And([m.Link("Member", [m.Node("Gene", gene), m.Variable("V3")], True),
                  m.Link("Member", [m.Variable("V2"), m.Variable("V3")], True)])


@pytest.fixture(scope="module")
def bio():
    jdata, genes, _ = jx_bio(**BIO)
    pdata, _, _ = build_bio_atomspace(**BIO)
    names = [jdata.nodes[h].name for h in genes]
    return (JxShardedDB(jdata, JxConfig(), mesh=jx_make_mesh(S)),
            ShardedDB(pdata, DasConfig(mesh_shape=(S,)), device="cpu"), names)


def _or_suite(m, n):
    return [
        m.Or([_branch(m, n[0]), _branch(m, n[2])]),
        m.Or([_branch(m, n[0]), _branch(m, n[1]), m.Not(_branch(m, n[2]))]),
    ]


@pytest.mark.parametrize("qi", [0, 1])
def test_sharded_tree_job_equals_das_tpu(bio, qi):
    import jax

    jdb, pdb, names = bio
    jnode = jx_plan.build_plan(jdb, _or_suite(jx_ast, names)[qi])
    pnode = plan.build_plan(pdb, _or_suite(ast, names)[qi])
    jsites, pites = jx_tree.tree_fusion_sites(jnode), tree.tree_fusion_sites(pnode)
    jjob = jx_fs.get_sharded_executor(jdb).tree_exec_job(jsites[0], jsites[1])
    while True:
        out = jjob.dispatch()
        jhost = jax.device_get(out)
        if jjob.settle(jhost, out):
            break
    pjob = fs.get_sharded_executor(pdb).tree_exec_job(pites[0], pites[1])
    compiler.reset_route_counts()
    while True:
        out = pjob.dispatch()
        phost = fused.fetch(*out)
        if pjob.settle(phost, out):
            break
    assert compiler.ROUTE_COUNTS["sharded_tree_fused"] == 1
    assert pjob.rounds == jjob.rounds and pjob.matched_any == jjob.matched_any
    assert [int(x) for x in phost[-1]] == [int(x) for x in np.asarray(jhost[2])]
    assert np.array_equal(pjob.result.host_vals, np.asarray(jhost[0]))
    assert np.array_equal(pjob.result.host_valid, np.asarray(jhost[1]))
    # the mesh job's answers equal the staged tree's (fusion off)
    fa, sa = ast.PatternMatchingAnswer(), ast.PatternMatchingAnswer()
    fm = tree.query_tree_fused(pdb, pnode, fa)
    pdb.config.use_tree_fusion = "off"
    try:
        sm = tree.query_tree(pdb, _or_suite(ast, names)[qi], sa)
    finally:
        pdb.config.use_tree_fusion = "auto"
    assert (bool(fm), fa.negation) == (bool(sm), sa.negation)
    assert fa.assignments == sa.assignments
