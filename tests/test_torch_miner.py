"""The pattern miner (`das_tpu_torch/mining/`) against the JAX package's
under the same seed: halo levels, universe, every candidate with its count
and level, the joint cache, and the best stochastic and exhaustive
patterns with their I-Surprisingness, compared exactly (the same float
arithmetic on equal integers).  On the animals KB the port's miner runs on
a TensorDB (on the CPU) and on a MemoryDB, and das_tpu's on a MemoryDB (the
host algebra); its unordered Similarity candidates reach the port's tree
executor.  On a small bio KB both run on a TensorDB, the port with its
star joints counted by each edition of the fold and with the star route
taken away (its joints then go through `count_batch`); then after an
incremental commit.  Last, the
scoring and memoization tests of tests/test_miner.py, ported as they are."""

import pytest

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.mining import PatternMiner as JxMiner
from das_tpu.models.animals import animals_metta as jx_animals_metta
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import compiler as jx_compiler
from das_tpu.storage import atom_table as jx_atom_table
from das_tpu.storage.memory_db import MemoryDB as JxMemoryDB
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.mining import PatternMiner
from das_tpu_torch.mining.miner import _Candidate
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast, compiler, starcount, tree
from das_tpu_torch.query.fused import get_executor
from das_tpu_torch.storage import atom_table
from das_tpu_torch.storage.memory_db import MemoryDB
from das_tpu_torch.storage.tensor_db import TensorDB

HUMAN = "af12f10f9ae2002a1607ba0b47ba8407"
BIO = dict(n_genes=120, n_processes=10, members_per_gene=4, n_interactions=150,
           n_evaluations=30)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    monkeypatch.setenv("DAS_TPU_STAR_FOLD", "host")
    for var in ("DAS_TPU_STAR", "DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER",
                "DAS_TPU_VMEM_BUDGET"):
        monkeypatch.delenv(var, raising=False)


def _state(m):
    """Everything a run decides, in comparable form."""
    return {
        "levels": [sorted(level) for level in m.levels],
        "universe": m.universe_size,
        "candidates": [(repr(c.pattern), c.count, c.level) for lv in m.candidates for c in lv],
        "joints": sorted((tuple(sorted(k)), n) for k, n in m._joint_count_cache.items()),
    }


def _best(b):
    return None if b is None else (repr(b.pattern), b.count, b.isurprisingness, b.term_handles)


def _animals_run(miner_cls, db):
    m = miner_cls(db, halo_length=2, link_rate=1.0, seed=3)
    m.expand_halo([HUMAN])
    m.build_patterns()
    sto = m.mine(ngram=2, epochs=30)
    exh = m.mine_exhaustive(ngram=2)
    return _state(m), _best(sto), _best(exh)


@pytest.fixture(scope="module")
def animals_want():
    db = JxMemoryDB(jx_atom_table.load_metta_text(jx_animals_metta()))
    return _animals_run(JxMiner, db)


@pytest.mark.parametrize("backend", ["tensor", "memory"])
def test_animals_miner_equals_das_tpu(animals_want, backend, monkeypatch):
    data = atom_table.load_metta_text(animals_metta())
    db = TensorDB(data, DasConfig(), device="cpu") if backend == "tensor" else MemoryDB(data)
    calls = {"tree": 0}
    real = tree.query_tree

    def spy(*a, **kw):
        calls["tree"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tree, "query_tree", spy)
    compiler.reset_route_counts()
    got = _animals_run(PatternMiner, db)
    assert got == animals_want
    state, sto, exh = got
    assert state["universe"] == sum(len(lv) for lv in state["levels"]) > 0
    assert any("Similarity" in c[0] for c in state["candidates"])
    assert sto is not None and exh is not None and exh[2] >= sto[2]
    if backend == "tensor":
        # unordered candidates: count_matches -> the tree executor, which
        # moves no route counter (in das_tpu neither); ordered joints: star
        assert calls["tree"] > 0 and compiler.ROUTE_COUNTS["host"] == 0
        assert compiler.ROUTE_COUNTS["star"] > 0
    else:
        assert calls["tree"] == 0 and compiler.ROUTE_COUNTS["host"] > 0


# -- the bio KB on both packages' TensorDB ---------------------------------------


def _bio_run(miner_cls, db, seed=11):
    m = miner_cls(db, halo_length=2, link_rate=0.3, seed=seed)
    genes = db.get_all_nodes("Gene", names=True)[:2]
    m.expand_halo([db.get_node_handle("Gene", g) for g in genes])
    m.build_patterns()
    best = m.mine(ngram=3, epochs=40)
    return _state(m), _best(best)


@pytest.fixture(scope="module")
def bio_want():
    jdata, _, _ = jx_bio(**BIO)
    jx_compiler.reset_route_counts()
    want = _bio_run(JxMiner, JxTensorDB(jdata, JxConfig()))
    return want, dict(jx_compiler.ROUTE_COUNTS)


@pytest.mark.parametrize("mode", ["host", "device", "star_off"])
def test_bio_miner_equals_das_tpu(bio_want, mode, monkeypatch):
    """"device" counts the star joints by the device edition of the fold;
    "star_off" declines every star lane, so the joints take the general
    executors."""
    (want, want_routes) = bio_want
    pdata, _, _ = build_bio_atomspace(**BIO)
    if mode == "device":
        monkeypatch.setattr(starcount, "star_count_many", starcount._device_count_group)
    elif mode == "star_off":
        monkeypatch.setattr(starcount, "plan_star", lambda db, plans: None)
    db = TensorDB(pdata, DasConfig(), device="cpu")
    compiler.reset_route_counts()
    f0 = starcount.FETCHES["n"]
    got = _bio_run(PatternMiner, db)
    routes = dict(compiler.ROUTE_COUNTS)
    assert got == want
    state, best = got
    assert len(state["levels"][1]) > 0 and any(c[2] == 1 for c in state["candidates"])
    assert len(state["joints"]) > 0 and best is not None
    if mode == "star_off":
        # every joint through count_batch on the fused executor
        assert routes["star"] == 0 and get_executor(db).batch_counts["groups"] > 0
    else:
        assert {k: v for k, v in routes.items() if v} == \
            {k: v for k, v in want_routes.items() if v}
        assert routes["star"] > 0
        assert (starcount.FETCHES["n"] > f0) == (mode == "device")


def test_count_many_falls_back_to_staged(monkeypatch):
    """count_batch's None goes straight to count_matches_staged, and its
    count is the one count_matches gives.  The joints are stars: every star
    lane is declined so that they reach count_batch."""
    monkeypatch.setattr(starcount, "plan_star", lambda db, plans: None)
    pdata, _, _ = build_bio_atomspace(**BIO)
    db = TensorDB(pdata, DasConfig(), device="cpu")
    m = PatternMiner(db, seed=1)
    genes = db.get_all_nodes("Gene", names=True)
    L, V, N = ast.Link, ast.Variable, ast.Node
    qs = [ast.And([L("Member", [N("Gene", g), V("V0")], True),
                   L("Member", [V("T1_V1"), V("V0")], True)]) for g in genes[:4]]
    staged = []
    real = compiler.count_matches_staged
    monkeypatch.setattr(compiler, "count_matches_staged",
                        lambda d, p: staged.append(p) or real(d, p))
    ex = get_executor(db)
    monkeypatch.setattr(ex, "count_batch", lambda plans_list: [None] * len(plans_list))
    got = m.count_many(qs)
    assert len(staged) == len(qs)
    assert got == [compiler.count_matches(db, q) for q in qs] and min(got) > 0


def _eval_commit(names):
    g, p = names
    lines = [f'(: "{x}" Gene)' for x in g[:4]] + [f'(: "{x}" BiologicalProcess)' for x in p[:2]]
    lines.append('(: "Predicate:has_name" Predicate)')
    for i in range(4):
        lines += [f'(Member "{g[i]}" "{p[i % 2]}")',
                  f'(Evaluation "Predicate:has_name" (List "{g[i]}" "{p[(i + 1) % 2]}"))',
                  f'(: "NEWG_{i}" Gene)', f'(Interacts "NEWG_{i}" "{g[i]}")']
    return "\n".join(lines)


def test_miner_after_commit_equals_das_tpu():
    """After an incremental commit (overlay rows, the delta incoming sets,
    Evaluation links whose List target is itself a link, where
    get_node_type raises), the port's TensorDB miner equals das_tpu's miner
    on a MemoryDB of the same committed data (the host algebra)."""
    cfg = dict(BIO, n_genes=40, n_interactions=40, n_evaluations=20)
    jdata, _, _ = jx_bio(**cfg)
    pdata, _, _ = build_bio_atomspace(**cfg)
    db = TensorDB(pdata, DasConfig(), device="cpu")
    names = (db.get_all_nodes("Gene", names=True), db.get_all_nodes("BiologicalProcess",
                                                                     names=True))
    text = _eval_commit(names)
    atom_table.load_metta_text(text, pdata)
    jx_atom_table.load_metta_text(text, jdata)
    v0 = db.delta_version
    db.refresh()
    assert db.delta_version == v0 + 1 and db._delta_total > 0
    seeds = [db.get_node_handle("Gene", g) for g in names[0][:4]]
    # the overlay's links are in the incoming sets, and a link target raises
    jmem = JxMemoryDB(jdata)
    for h in seeds:
        assert sorted(db.get_incoming(h)) == sorted(jmem.get_incoming(h))
    evals = [h for h in db.get_incoming(seeds[0])
             if db.get_atom_as_dict(h)["type"] == "List"]
    assert evals
    with pytest.raises(ValueError):
        db.get_node_type(evals[-1])
    assert db.get_atom_as_dict(evals[-1]) == jmem.get_atom_as_dict(evals[-1])

    runs = []
    for miner_cls, store in ((JxMiner, jmem), (PatternMiner, db)):
        m = miner_cls(store, halo_length=2, link_rate=0.5, seed=4)
        # a committed List link as a seed: its incoming Evaluation links
        # are candidates, whose variants grounding the List are skipped
        m.expand_halo(seeds + evals[-1:])
        m.build_patterns()
        best = m.mine(ngram=2, epochs=12)
        runs.append((_state(m), _best(best)))
    assert runs[0] == runs[1]
    assert any("Evaluation" in c[0] for c in runs[1][0]["candidates"])


# -- tests/test_miner.py, ported --------------------------------------------------


@pytest.fixture(scope="module")
def miner():
    m = PatternMiner(MemoryDB(atom_table.load_metta_text(animals_metta())),
                     halo_length=2, link_rate=1.0, seed=3)
    m.expand_halo([HUMAN])
    return m


def test_halo_expansion(miner):
    assert len(miner.levels[0]) > 0
    assert all(h not in miner.levels[1] for h in miner.levels[0])
    assert miner.universe_size == sum(len(lv) for lv in miner.levels)
    assert miner.universe_size <= 26


def test_build_patterns_counts(miner):
    assert miner.build_patterns() > 0
    for level in miner.candidates:
        for c in level:
            assert c.count >= 1
            assert miner.count(c.pattern) == c.count


def test_mine_stochastic(miner):
    if not miner.candidates:
        miner.build_patterns()
    best = miner.mine(ngram=2, epochs=30)
    assert best is not None and best.count >= 1


def test_mine_exhaustive_beats_or_ties_stochastic(miner):
    if not miner.candidates:
        miner.build_patterns()
    sto = miner.mine(ngram=2, epochs=30)
    exh = miner.mine_exhaustive(ngram=2)
    assert exh is not None
    assert exh.isurprisingness >= sto.isurprisingness


def test_device_counting_path():
    data = atom_table.load_metta_text(animals_metta())
    m = PatternMiner(TensorDB(data, device="cpu"), halo_length=1, link_rate=1.0)
    m.expand_halo([HUMAN])
    m.build_patterns()
    best = m.mine(ngram=2, epochs=20)
    assert best is not None
    answer = ast.PatternMatchingAnswer()
    matched = best.pattern.matched(MemoryDB(data), answer)
    assert (len(answer.assignments) if matched else 0) == best.count


def _fake_candidate(name, count):
    return _Candidate(ast.Link(name, [ast.Variable("V1"), ast.Variable("V2")], True), count, 0)


def test_isurprisingness_negative_branch(miner):
    """An anti-correlated pair (joint far below independence) scores
    positive through the min(est) - p branch."""
    a, b = _fake_candidate("TA", 400), _fake_candidate("TB", 400)
    saved = miner.universe_size
    miner.universe_size = 1000
    try:
        assert miner.isurprisingness(10, [a, b]) == pytest.approx(0.16 - 0.01)
        assert miner.isurprisingness(10, [a, b], normalized=True) == \
            pytest.approx((0.16 - 0.01) / 0.01)
    finally:
        miner.universe_size = saved


def test_isurprisingness_22_partitions(miner):
    """At n=4 the (2,2) partitions join the estimate band: two correlated
    pairs, independent of each other, are not surprising."""
    terms = [_fake_candidate(f"T{i}", 100) for i in range(4)]
    saved, saved_cache = miner.universe_size, dict(miner._joint_count_cache)
    miner.universe_size = 1000
    miner._joint_count_cache.clear()
    joints = {(0, 1): 100, (2, 3): 100, (0, 2): 10, (0, 3): 10, (1, 2): 10, (1, 3): 10,
              (0, 1, 2): 10, (0, 1, 3): 10, (0, 2, 3): 10, (1, 2, 3): 10}
    try:
        for idxs, n in joints.items():
            miner._joint_count_cache[frozenset(repr(terms[i].pattern) for i in idxs)] = n
        assert miner.isurprisingness(10, terms) == pytest.approx(0.0, abs=1e-12)
    finally:
        miner.universe_size = saved
        miner._joint_count_cache = saved_cache


def test_joint_count_memoized(miner):
    if not miner.candidates:
        miner.build_patterns()
    miner._joint_count_cache.clear()
    calls = []
    original = miner.count

    def counting(q):
        calls.append(q)
        return original(q)

    miner.count = counting
    try:
        flat = [c for level in miner.candidates for c in level][:3]
        assert len(flat) == 3
        miner.isurprisingness(1, flat)
        first = len(calls)
        assert first > 0
        miner.isurprisingness(1, flat)
        assert len(calls) == first
    finally:
        miner.count = original


def test_depth_weight_length_is_checked():
    with pytest.raises(ValueError):
        PatternMiner(MemoryDB(), halo_length=2, depth_weight=[1.0])
