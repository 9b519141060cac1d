"""Queries through the port (das_tpu_torch, device="cpu") against the JAX
package (das_tpu, cost planner and multiway off) on the same data: equal
answers on the animals battery and on the three smoke query shapes of
bench.py (grounded 3-clause, its Not variant, the all-variable triangle),
equal `count_matches`, equal final stats vectors; plus the capacity retry,
the reseed answered by the exact program and the one-host-fetch-per-round
contract."""

import numpy as np
import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query.fused import get_executor as jx_executor
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query.fused import FETCH_COUNTS, get_executor
from das_tpu_torch.storage.atom_table import load_metta_text

#: bench.py SMALL
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5,
             n_interactions=300, n_evaluations=0)


def _jx_config(**kw):
    return JxConfig(use_planner="off", use_multiway="off", **kw)


def _canon(a):
    """Package-independent identity of one assignment."""
    if hasattr(a, "ordered_mapping"):
        return ("C", _canon(a.ordered_mapping) if a.ordered_mapping else None,
                tuple(sorted(_canon(u) for u in a.unordered_mappings)))
    if hasattr(a, "symbols"):
        return ("U", tuple(sorted(a.symbols.items())), tuple(sorted(a.values.items())))
    return ("O", tuple(sorted(a.mapping.items())))


def _answer(das, q):
    matched, answer = das.query_answer(q)
    return bool(matched), answer.negation, sorted(_canon(a) for a in answer.assignments)


def _build(mod, spec):
    """Build the same query in either package from a nested spec."""
    kind = spec[0]
    if kind == "N":
        return mod.Node(spec[1], spec[2])
    if kind == "V":
        return mod.Variable(spec[1])
    if kind == "T":
        return mod.TypedVariable(spec[1], spec[2])
    if kind == "L":
        return mod.Link(spec[1], [_build(mod, t) for t in spec[2]], spec[3])
    if kind == "LT":
        return mod.LinkTemplate(spec[1], [_build(mod, t) for t in spec[2]], spec[3])
    if kind in ("And", "Or"):
        return getattr(mod, kind)([_build(mod, t) for t in spec[1]])
    if kind == "Not":
        return mod.Not(_build(mod, spec[1]))
    raise ValueError(kind)


def _inh(a, b):
    return ("L", "Inheritance", [a, b], True)


def _c(name):
    return ("N", "Concept", name)


V1, V2, V3 = ("V", "V1"), ("V", "V2"), ("V", "V3")

ANIMALS = [
    _inh(V1, _c("mammal")),
    ("And", [_inh(V1, V2), _inh(V2, V3)]),
    ("And", [_inh(V1, _c("mammal")), _inh(V1, V2)]),
    ("And", [_inh(V1, V2), ("Not", _inh(V1, _c("mammal")))]),
    ("And", [_inh(V1, _c("mammal")), ("Not", _inh(V1, _c("unicorn")))]),
    ("And", [_inh(V1, V1)]),                                    # repeated variable
    _inh(V1, _c("unicorn")),                                    # unknown node
    ("LT", "Inheritance", [("T", "V1", "Concept"), ("T", "V2", "Concept")], True),
    ("And", [("L", "Similarity", [V1, V2], False), _inh(V1, _c("mammal"))]),  # tree
    ("Or", [_inh(V1, _c("plant")), _inh(V1, _c("reptile"))]),                 # tree
    # reseed: the first join empties the accumulator, the third term
    # re-seeds it (the reference's And quirk)
    ("And", [_inh(V1, _c("mammal")), _inh(V1, _c("reptile")), _inh(V2, _c("plant"))]),
]


@pytest.fixture(scope="module")
def animals_pair():
    jx = JxDAS(backend="tensor", data=jx_load(jx_animals()), config=_jx_config())
    pt = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                              device="cpu")
    return jx, pt


@pytest.mark.parametrize("spec", ANIMALS, ids=range(len(ANIMALS)))
def test_animals_answers_equal(animals_pair, spec):
    jx, pt = animals_pair
    want = _answer(jx, _build(jx_ast, spec))
    got = _answer(pt, _build(ast, spec))
    assert want == got


def test_animals_routes():
    pt = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                              device="cpu")
    compiler.reset_route_counts()
    pt.query_answer(_build(ast, ANIMALS[1]))
    pt.query_answer(_build(ast, ANIMALS[8]))
    # the reseed query is answered by the exact reference-order program,
    # a fused route, as in das_tpu
    pt.query_answer(_build(ast, ANIMALS[-1]))
    assert compiler.ROUTE_COUNTS == {"fused": 2, "fused_kernel": 0, "fused_multiway": 0,
                                     "fused_tree": 0, "sharded_tree_fused": 0, "staged": 0,
                                     "tree": 1, "sharded": 0, "sharded_kernel": 0,
                                     "sharded_multiway": 0, "count_kernel": 0, "host": 0,
                                     "star": 0}


def _grounded(gene, negate=False):
    third = ("L", "Interacts", [("N", "Gene", gene), V2], True)
    return ("And", [
        ("L", "Member", [("N", "Gene", gene), V3], True),
        ("L", "Member", [V2, V3], True),
        ("Not", third) if negate else third,
    ])


TRIANGLE = ("And", [
    ("L", "Member", [V1, V3], True),
    ("L", "Member", [V2, V3], True),
    ("L", "Interacts", [V1, V2], True),
])


@pytest.fixture(scope="module")
def bio_pair():
    jdata, genes, _ = jx_bio(seed=3, **SMALL)
    jx = JxDAS(backend="tensor", data=jdata, config=_jx_config())
    pdata, _, _ = build_bio_atomspace(seed=3, **SMALL)
    pt = DistributedAtomSpace(backend="tensor", data=pdata, device="cpu")
    names = [jdata.nodes[h].name for h in genes]
    # genes whose grounded answer is non-empty, and some that are not
    picks = [names[i] for i in (0, 1, 2, 5)]
    return jx, pt, picks


def _bio_specs(picks):
    return ([_grounded(g) for g in picks] + [_grounded(g, True) for g in picks[:2]]
            + [TRIANGLE])


def test_bio_smoke_shapes_answers_and_counts(bio_pair):
    jx, pt, picks = bio_pair
    nonempty = 0
    for spec in _bio_specs(picks):
        want = _answer(jx, _build(jx_ast, spec))
        got = _answer(pt, _build(ast, spec))
        assert want == got
        nonempty += bool(got[2])
        assert (jx_compiler.count_matches(jx.db, _build(jx_ast, spec))
                == compiler.count_matches(pt.db, _build(ast, spec)))
    assert nonempty >= 3


def _jx_stats(db, plans):
    """The JAX fused executor's final-round stats vector."""
    job = jx_executor(db)._exec_job(plans, True)
    while True:
        out = job.dispatch()
        stats = np.asarray(out)
        if job.settle(stats, out):
            return stats


def test_bio_stats_vectors_equal(bio_pair):
    jx, pt, picks = bio_pair
    for spec in _bio_specs(picks[:2]):
        jplans = jx_compiler.plan_query(jx.db, _build(jx_ast, spec))
        pplans = compiler.plan_query(pt.db, _build(ast, spec))
        res = get_executor(pt.db).execute(pplans, count_only=True)
        want = _jx_stats(jx.db, jplans)
        assert want.tolist() == res.stats.tolist()


def test_capacity_retry_one_fetch_per_round():
    data, _, _ = build_bio_atomspace(seed=3, **SMALL)
    # the greedy order with its blind seed: the planner's seeds would fit
    pt = DistributedAtomSpace(backend="tensor", data=data, device="cpu",
                              config=DasConfig(initial_result_capacity=16,
                                               use_planner="off", use_multiway="off"))
    plans = compiler.plan_query(pt.db, _build(ast, TRIANGLE))
    n0 = FETCH_COUNTS["n"]
    res = get_executor(pt.db).execute(plans)
    assert res.rounds >= 2                     # the seed capacity overflowed
    assert FETCH_COUNTS["n"] - n0 == res.rounds
    # the learned capacities start the next call right-sized: one round
    n0 = FETCH_COUNTS["n"]
    res2 = get_executor(pt.db).execute(plans)
    assert res2.rounds == 1 and FETCH_COUNTS["n"] - n0 == 1
    assert res2.count == res.count
    # materializing the answer reuses the copies fetched with the stats
    compiler.reset_route_counts()
    n0 = FETCH_COUNTS["n"]
    pt.query_answer(_build(ast, TRIANGLE))
    assert FETCH_COUNTS["n"] - n0 == 1 and compiler.ROUTE_COUNTS["fused"] == 1
    jx = JxDAS(backend="tensor", data=jx_bio(seed=3, **SMALL)[0],
               config=_jx_config(initial_result_capacity=16))
    assert _answer(jx, _build(jx_ast, TRIANGLE)) == _answer(pt, _build(ast, TRIANGLE))


def test_load_knowledge_base_then_query(tmp_path, animals_pair):
    """A .metta file loaded into an empty tensor store (full re-upload on
    refresh) answers like the JAX store built from the same text."""
    from das_tpu_torch.models.animals import write_animals_metta

    path = write_animals_metta(str(tmp_path / "animals.metta"))
    pt = DistributedAtomSpace(backend="tensor", device="cpu")
    pt.load_knowledge_base(str(tmp_path))
    assert pt.count_atoms() == (14, 26)
    jx, _ = animals_pair
    for spec in ANIMALS[:4]:
        assert _answer(jx, _build(jx_ast, spec)) == _answer(pt, _build(ast, spec))
    pt2 = DistributedAtomSpace(backend="tensor", device="cpu")
    pt2.load_metta_text(open(path).read())
    assert _answer(pt2, _build(ast, ANIMALS[1])) == _answer(pt, _build(ast, ANIMALS[1]))


def test_run_conj_probes_each_plan_in_one_call(bio_pair, monkeypatch):
    """run_conj probes every materialized term of a plan in ONE
    probe_term_tables call (one launch on the card), never term by term,
    and answers as before."""
    from das_tpu_torch import kernels
    from das_tpu_torch.query import fused

    _jx, pt, picks = bio_pair
    calls = {"conj": 0, "tables": [], "table": 0}

    def spy(fn, record):
        def wrapped(*a, **kw):
            record(a)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused, "run_conj", spy(
        fused.run_conj, lambda a: calls.__setitem__("conj", calls["conj"] + 1)))
    monkeypatch.setattr(kernels, "probe_term_tables", spy(
        kernels.probe_term_tables, lambda a: calls["tables"].append(len(a[0]))))
    monkeypatch.setattr(kernels, "probe_term_table", spy(
        kernels.probe_term_table, lambda a: calls.__setitem__("table", calls["table"] + 1)))
    for spec in _bio_specs(picks[:2]):
        plans = compiler.plan_query(pt.db, _build(ast, spec))
        ex = get_executor(pt.db)
        res = ex.execute(plans, count_only=True)
        assert res.count == compiler.count_matches(pt.db, _build(ast, spec))
    assert calls["conj"] >= 5 and len(calls["tables"]) == calls["conj"]
    assert calls["table"] == 0 and max(calls["tables"]) >= 2
