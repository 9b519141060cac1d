"""The port's fault injection and recovery (das_tpu_torch/fault/) against
das_tpu's (das_tpu/fault/): the declared sites, the same spec firing on
the same call indices per site, the same backoff sequences and the same
circuit-breaker state sequence; `is_retryable` refusing a CUDA-style
runtime error (a deliberate difference).  Then chaos parity on the port's
tensor backend (device="cpu"): every FAULT_SITES entry injected, answers
equal to the fault-free ones and to das_tpu's (memory backend); an injected `commit_apply` leaves the device
tables as they were and the retried commit gives das_tpu's tables; a
crash-point matrix over the durable sites restores to the same answers."""

import re
import threading
from ast import literal_eval
from types import SimpleNamespace

import numpy as np
import pytest

from das_tpu import fault as jx_fault
from das_tpu.core.exceptions import InjectedFault as JxInjectedFault
from das_tpu_torch import fault, obs
from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import DasError, InjectedFault
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query.ast import And, Link, Node, Variable
from das_tpu_torch.service.coalesce import QueryCoalescer
from das_tpu_torch.storage.atom_table import load_metta_text

HANDLE = QueryOutputFormat.HANDLE


@pytest.fixture(autouse=True)
def _clean():
    """No plan or recorder state leaks into the next test of the worker."""
    yield
    fault.configure(None)
    fault.reset_counts()
    jx_fault.configure(None)
    jx_fault.reset_counts()
    obs.reset()
    obs.configure(enabled=False)


def test_fault_sites_equal_das_tpu():
    assert fault.FAULT_SITES == jx_fault.FAULT_SITES
    assert set(fault.INJECT_COUNTS) == set(fault.FAULT_SITES)


def _fired(mod, exc_type, spec, calls=24):
    """{site: call indices that raised} of one armed plan."""
    plan = mod.parse_spec(spec)
    out = {}
    for site in mod.FAULT_SITES:
        out[site] = []
        for n in range(calls):
            try:
                plan.check(site)
            except exc_type:
                out[site].append(n)
    return out


@pytest.mark.parametrize("spec", [
    "seed=7;sites=*;rate=0.3;max=6",
    "seed=3;sites=settle_fetch,commit_apply,wal_fsync;rate=0.5;max=24",
    "seed=0;sites=*;every=3;max=4",
])
def test_schedule_fires_on_the_same_calls(spec):
    got = _fired(fault, InjectedFault, spec)
    want = _fired(jx_fault, JxInjectedFault, spec)
    assert got == want
    assert any(got.values())


def test_spec_errors_and_disabled_path(monkeypatch):
    for bad in ("sites=nope", "seed=1", "seed=1;sites=*;mode=loud", "bogus=1;sites=*",
                "seed"):
        with pytest.raises(fault.FaultSpecError):
            fault.parse_spec(bad)
    assert fault.parse_spec("") is None and fault.parse_spec(None) is None
    monkeypatch.setenv("DAS_TPU_FAULT", "seed=1;sites=*;every=1")
    fault.configure(None)
    assert fault.plan() is None and not fault.enabled()
    fault.maybe_fail("settle_fetch")  # no plan: nothing fires
    fault.configure("seed=1;sites=submit_queue;every=1;max=1")
    with pytest.raises(InjectedFault) as err:
        fault.maybe_fail("submit_queue")
    assert (err.value.site, err.value.call, err.value.retryable) == ("submit_queue", 0, True)
    assert fault.INJECT_COUNTS["submit_queue"] == 1
    assert fault.plan().snapshot()["failures"] == {"submit_queue": 1}


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_backoff_sequences_equal(seed):
    for kw in ({}, {"base_ms": 0.5, "multiplier": 3.0, "max_backoff_ms": 20.0,
                    "jitter_frac": 0.5}):
        p = fault.RetryPolicy(max_attempts=6, seed=seed, **kw)
        jp = jx_fault.RetryPolicy(max_attempts=6, seed=seed, **kw)
        assert [p.backoff_ms(a) for a in range(1, 9)] == [jp.backoff_ms(a) for a in range(1, 9)]
    assert (fault.fetch_retry().backoff_ms(2), fault.commit_retry().max_attempts) == (
        jx_fault.fetch_retry().backoff_ms(2), jx_fault.commit_retry().max_attempts)


def test_retry_policy_runs_and_classifies():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise InjectedFault("settle_fetch", calls["n"])
        return "ok"

    seen = []
    assert fault.RetryPolicy(max_attempts=3, base_ms=0.01).run(
        flaky, on_retry=lambda a, e: seen.append(a)) == "ok"
    assert calls["n"] == 3 and seen == [1, 2]
    calls["n"] = 0

    def cuda_error():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError):
        fault.RetryPolicy(max_attempts=3, base_ms=0.01).run(cuda_error)
    assert calls["n"] == 1


def test_is_retryable_refuses_device_errors():
    assert fault.is_retryable(InjectedFault("settle_fetch", 0))
    assert not fault.is_retryable(InjectedFault("settle_fetch", 0, retryable=False))
    assert fault.is_retryable(ConnectionResetError())
    for exc in (RuntimeError("CUDA error: unspecified launch failure"),
                RuntimeError("das kernel launch failed: cudaErrorLaunchFailure"),
                ValueError("bad query"), DasError("semantic")):
        assert not fault.is_retryable(exc), exc


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_states(mod):
    clock = _Clock()
    b = mod.CircuitBreaker(failure_threshold=3, cooldown_ms=100.0, clock=clock)
    out = []
    script = ["f", "f", "s", "f", "f", "f", "a", "t50", "a", "t60", "a", "a", "f", "a",
              "t120", "a", "s", "a", "f", "f", "f", "a"]
    for step in script:
        if step == "f":
            b.record_failure()
        elif step == "s":
            b.record_success()
        elif step == "a":
            out.append(b.allow())
        else:
            clock.t += float(step[1:]) / 1e3
        out.append((b.state, b.retry_after_ms(), b.snapshot()))
    return out


def test_breaker_state_sequence_equals_das_tpu():
    got = _breaker_states(fault)
    assert got == _breaker_states(jx_fault)
    snaps = [s for s in got if isinstance(s, tuple)]
    assert snaps[-1][2]["trips"] == 2 and snaps[-1][2]["recoveries"] == 1


# -- chaos parity on the port's tensor backend ------------------------------

_BIO = dict(n_genes=40, n_processes=6, members_per_gene=3, n_interactions=40,
            n_evaluations=8, seed=1)


def _gene_query(gene, m=ast):
    return m.And([
        m.Link("Member", [m.Node("Gene", gene), m.Variable("V3")], True),
        m.Link("Member", [m.Variable("V2"), m.Variable("V3")], True),
        m.Link("Interacts", [m.Node("Gene", gene), m.Variable("V2")], True),
    ])


def _as_set(answer):
    """A HANDLE answer as the sorted list of its assignments, each with its
    keys sorted: an answer is a set, printed in an order that differs
    between the packages."""
    return (answer.startswith("NOT "),
            sorted(tuple(sorted(literal_eval(d).items()))
                   for d in re.findall(r"\{[^{}]*\}", answer)))


def _reference_answers(bio_kw, gene_names, extra=()):
    """das_tpu's answers to the gene queries (and `extra`, built from
    das_tpu's AST) on the same bio store, on its memory backend, which
    compiles nothing."""
    from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
    from das_tpu.api.atomspace import QueryOutputFormat as JxFormat
    from das_tpu.models.bio import build_bio_atomspace as jx_bio
    from das_tpu.query import ast as jx_ast

    jdata, jgenes, _ = jx_bio(**bio_kw)
    assert [jdata.nodes[h].name for h in jgenes[:len(gene_names)]] == list(gene_names)
    jx = JxDAS(backend="memory", data=jdata)
    queries = [_gene_query(g, jx_ast) for g in gene_names]
    queries += [build(jx_ast) for build in extra]
    return [_as_set(jx.query(q, JxFormat.HANDLE)) for q in queries]


@pytest.fixture(scope="module")
def served():
    data, genes, _ = build_bio_atomspace(**_BIO)
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu")
    names = [data.nodes[h].name for h in genes[:6]]
    queries = [_gene_query(g) for g in names]
    baseline = [das.query(q) for q in queries]
    assert sum(bool(b) for b in baseline) >= 2
    reference = _reference_answers(_BIO, names)
    assert [_as_set(b) for b in baseline] == reference
    return data, queries, baseline, reference


def _coalescer():
    return QueryCoalescer(max_batch=8, pipeline_depth=2, pipeline_depth_max=4, queue_max=0,
                          deadline_ms=0, breaker_threshold=0, breaker_cooldown_ms=100)


SERVING_SITES = ("submit_queue", "worker_iteration", "dispatch_enqueue", "settle_fetch",
                 "cache_insert")


@pytest.mark.parametrize("site", SERVING_SITES)
def test_chaos_parity_serving_sites(served, site):
    """Coalesced traffic under a seeded plan over one serving site: every
    answer equals the fault-free one, except that a submit_queue failure
    comes back typed on its own future; the worker serves on afterwards."""
    data, queries, baseline, reference = served
    # a fresh store: its result cache starts empty, so every site is reached
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu")
    tenant = SimpleNamespace(das=das, lock=threading.RLock(), name="t")
    coal = _coalescer()
    fault.configure(f"seed=11;sites={site};every=2;max=3")
    futs = [coal.submit(tenant, q, HANDLE) for q in queries + queries]
    typed = 0
    for fut, want, ref in zip(futs, baseline + baseline, reference + reference):
        try:
            got = fut.result(timeout=60)
        except InjectedFault:
            assert site == "submit_queue"
            typed += 1
            continue
        assert got == want and _as_set(got) == ref
    assert fault.INJECT_COUNTS[site] > 0
    assert typed == (fault.INJECT_COUNTS[site] if site == "submit_queue" else 0)
    fault.configure(None)
    assert coal.submit(tenant, queries[0], HANDLE).result(timeout=60) == baseline[0]


def test_settle_fetch_retry_counts_every_attempt(served):
    """An injected first fetch attempt and its retry are two counted host
    fetches; the answers are unchanged."""
    from das_tpu_torch.query.fused import FETCH_COUNTS

    data, queries, baseline, _ = served
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu",
                               config=DasConfig(result_cache_size=0))
    assert das.query_many(queries) == baseline
    n0 = FETCH_COUNTS["n"]
    assert das.query_many(queries) == baseline
    clean = FETCH_COUNTS["n"] - n0
    fault.configure("seed=2;sites=settle_fetch;every=1;max=1")
    n1 = FETCH_COUNTS["n"]
    assert das.query_many(queries) == baseline
    assert fault.INJECT_COUNTS["settle_fetch"] == 1
    assert FETCH_COUNTS["n"] - n1 == clean + 1
    # count_batch's round fetch is a settle fetch too
    fault.configure("seed=2;sites=settle_fetch;every=1;max=1")
    from das_tpu_torch.query import compiler

    plans = [compiler.plan_query(das.db, q) for q in queries]
    counts = das.db.dev._fused_executor.count_batch(plans)
    assert fault.INJECT_COUNTS["settle_fetch"] == 2
    fault.configure(None)
    assert das.db.dev._fused_executor.count_batch(plans) == counts


def test_commit_apply_leaves_tables_then_retry_equals_das_tpu():
    from tests.test_torch_commit import LION_TIGER, QUERIES, _check, _commit, _pair
    from tests.test_torch_query import _answer, _build
    from das_tpu_torch.query import ast

    jx, pt = pair = _pair()
    db = pt.db
    snap = _tables(db)
    version = db.delta_version
    want = [_answer(pt, _build(ast, spec)) for spec in QUERIES]
    fault.configure("seed=1;sites=commit_apply;every=1;max=10")
    with pytest.raises(InjectedFault):
        _commit(pt, LION_TIGER)
    assert fault.INJECT_COUNTS["commit_apply"] == 3  # every attempt of the policy
    assert db.delta_version == version
    _assert_same(snap, _tables(db))
    assert [_answer(pt, _build(ast, spec)) for spec in QUERIES] == want
    # one failure, then the policy's second attempt lands
    fault.configure("seed=1;sites=commit_apply;every=1;max=1")
    _commit(pt, LION_TIGER)
    assert db.delta_version == version + 1
    fault.configure(None)
    _commit(jx, LION_TIGER)
    _check(pair)


def _tables(db):
    """Host copies of every tensor of the device store."""
    out = {}
    for arity, b in sorted(db.dev.buckets.items()):
        for name, v in sorted(vars(b).items()):
            if hasattr(v, "numpy"):
                out[(arity, name)] = v.clone().numpy()
            elif isinstance(v, (tuple, list)):
                for i, t in enumerate(v):
                    if hasattr(t, "numpy"):
                        out[(arity, name, i)] = t.clone().numpy()
    assert out
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


_MAMMAL = And([Link("Inheritance", [Variable("V1"), Node("Concept", "mammal")], True),
               Link("Inheritance", [Variable("V1"), Variable("V2")], True)])


def _answers(das):
    return [das.query(_MAMMAL),
            das.query(Link("Inheritance", [Variable("V1"), Node("Concept", "mammal")], True))]


@pytest.mark.parametrize("site", ["snapshot_write", "snapshot_rename", "wal_append",
                                  "wal_fsync", "restore_read"])
def test_durable_crash_points_restore_same_answers(tmp_path, site):
    cfg = DasConfig(snapshot_dir=str(tmp_path))
    das = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                               device="cpu", config=cfg, database_name="kb")
    tx = das.open_transaction()
    tx.add('(: "lion" Concept)')
    tx.add('(Inheritance "lion" "mammal")')
    if site in ("snapshot_write", "snapshot_rename"):
        das.commit_transaction(tx)
        want = _answers(das)
        fault.configure(f"seed=1;sites={site};every=1;max=1")
        with pytest.raises(InjectedFault):
            das.save_snapshot()  # a crash while writing generation 2
        assert sorted(p.name for p in (tmp_path / "kb").iterdir()) == ["gen-000001"]
    elif site in ("wal_append", "wal_fsync"):
        fault.configure(f"seed=1;sites={site};every=1;max=1")
        das.commit_transaction(tx)  # the first append fails, the retry lands
        want = _answers(das)
    else:
        das.commit_transaction(tx)
        want = _answers(das)
        fault.configure(f"seed=1;sites={site};every=1;max=1")
    assert fault.INJECT_COUNTS[site] == (0 if site == "restore_read" else 1)
    restored = DistributedAtomSpace(backend="tensor", device="cpu", config=cfg,
                                    database_name="kb")
    assert fault.INJECT_COUNTS[site] == 1
    assert _answers(restored) == want
    assert restored.get_node("Concept", "lion") is not None
