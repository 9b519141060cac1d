"""Batched counting (`FusedExecutor.count_batch`) of the port against the
JAX package's on the same store: the same list of counts, with None at the
same positions, for the bench's grounded queries with repeats (lane
dedup), a mixed-shape list with undecidable entries, and entries only the
exact reference-order program answers; a repeated call is answered from
the result cache with no device work."""

import pytest

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query.fused import get_executor as jx_executor
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query.fused import FETCH_COUNTS, get_executor
from das_tpu_torch.storage.tensor_db import TensorDB

#: bench.py SMALL
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5, n_interactions=300,
             n_evaluations=0, seed=5)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS",
                "DAS_TPU_VMEM_BUDGET", "DAS_TPU_STAR"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def kb():
    jdata, genes, _ = jx_bio(**SMALL)
    pdata, _, _ = build_bio_atomspace(**SMALL)
    return jdata, pdata, [jdata.nodes[h].name for h in genes]


def _grounded(mod, g, negate=False):
    """bench.py grounded_query (and its Not variant)."""
    L, V, N = mod.Link, mod.Variable, mod.Node
    third = L("Interacts", [N("Gene", g), V("V2")], True)
    return mod.And([L("Member", [N("Gene", g), V("V3")], True),
                    L("Member", [V("V2"), V("V3")], True),
                    mod.Not(third) if negate else third])


def _mixed(mod, genes):
    """Shapes of every kind: grounded, Not, the triangle, a single term
    (counted on the host), a star, a term of an arity with no bucket
    (undecidable: None) and reseed shapes — two grounded Member terms that
    may share no process, then a whole-type Interacts term that re-seeds
    the emptied accumulator."""
    L, V, N = mod.Link, mod.Variable, mod.Node
    qs = [_grounded(mod, genes[0]), _grounded(mod, genes[1], True),
          mod.And([L("Member", [V("V1"), V("V3")], True), L("Member", [V("V2"), V("V3")], True),
                   L("Interacts", [V("V1"), V("V2")], True)]),
          L("Member", [N("Gene", genes[2]), V("P")], True),
          mod.And([L("Member", [N("Gene", genes[3]), V("V3")], True),
                   L("Member", [V("V2"), V("V3")], True),
                   L("Member", [V("V4"), V("V3")], True)]),
          mod.And([L("Member", [N("Gene", genes[4]), V("V3")], True),
                   L("Member", [V("V1"), V("V2"), V("V3")], True)])]
    for i in range(6):
        qs.append(mod.And([L("Member", [N("Gene", genes[10 + i]), V("V3")], True),
                           L("Member", [N("Gene", genes[20 + i]), V("V3")], True),
                           L("Interacts", [V("V1"), V("V2")], True)]))
    return qs


def _dbs(kb):
    jdata, pdata, genes = kb
    return JxTensorDB(jdata, JxConfig()), TensorDB(pdata, DasConfig(), device="cpu"), genes


def _plans(jdb, pdb, jqs, pqs):
    return ([jx_compiler.plan_query(jdb, q) for q in jqs],
            [compiler.plan_query(pdb, q) for q in pqs])


def test_count_batch_grounded_with_repeats(kb):
    jdb, pdb, genes = _dbs(kb)
    picks = genes[:48] + genes[:16]       # 64 queries, 16 repeated lanes
    jplans, pplans = _plans(jdb, pdb, [_grounded(jx_ast, g) for g in picks],
                            [_grounded(ast, g) for g in picks])
    want = jx_executor(jdb).count_batch(jplans)
    ex = get_executor(pdb)
    got = ex.count_batch(pplans)
    assert got == want and None not in got and sum(got) > 0
    assert ex.batch_counts == {"groups": 1, "lanes": 48, "members": 64, "exact_groups": 0}
    assert [compiler.count_matches(pdb, _grounded(ast, g)) for g in picks[:3]] == got[:3]
    # the second call: every entry from the result cache, no device work
    n0 = FETCH_COUNTS["n"]
    assert ex.count_batch(pplans) == got
    assert FETCH_COUNTS["n"] == n0 and ex.batch_counts["groups"] == 1
    assert ex.results.stats["hits"] == 64


def test_count_batch_mixed_and_exact_pass(kb):
    jdb, pdb, genes = _dbs(kb)
    jplans, pplans = _plans(jdb, pdb, _mixed(jx_ast, genes), _mixed(ast, genes))
    want = jx_executor(jdb).count_batch(jplans)
    ex = get_executor(pdb)
    got = ex.count_batch(pplans)
    assert got == want
    assert got[5] is None and sum(c is not None for c in got) == len(got) - 1
    # some reseed entries were answered by the exact reference-order program
    assert ex._exact_caps and ex.batch_counts["exact_groups"] >= 1
    # after the reseed the answer is the whole Interacts type
    n_interacts = compiler.count_matches(
        pdb, ast.Link("Interacts", [ast.Variable("V1"), ast.Variable("V2")], True))
    assert n_interacts in got[6:]
