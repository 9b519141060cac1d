"""The port's query coalescer (das_tpu_torch/service/coalesce.py): concurrent
submits on the tensor backend (device="cpu") answer as serial `query()`
does and as das_tpu does (memory backend); deadlines in the queued, grouped and in-flight states, backpressure,
and the breaker's trip, degraded serving and recovery give typed results;
the adaptive window formula and the snapshot's keys equal das_tpu's; a
commit between a speculative dispatch and its settle answers on the
committed store."""

import re
import threading
import time
from ast import literal_eval
from concurrent.futures import Future
from types import SimpleNamespace

import pytest

from das_tpu import fault as jx_fault
from das_tpu.service.coalesce import QueryCoalescer as JxCoalescer
from das_tpu_torch import fault, obs
from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import (
    BreakerOpenError,
    CoalescerSaturatedError,
    DasDeadlineError,
    InjectedFault,
)
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query.ast import Link, Node, Variable
from das_tpu_torch.service.coalesce import QueryCoalescer

HANDLE = QueryOutputFormat.HANDLE
_BIO = dict(n_genes=60, n_processes=8, members_per_gene=3, n_interactions=60,
            n_evaluations=0, seed=2)


@pytest.fixture(autouse=True)
def _clean():
    yield
    fault.configure(None)
    fault.reset_counts()
    jx_fault.configure(None)
    obs.reset()
    obs.configure(enabled=False)


def _coalescer(**kw):
    base = dict(max_batch=8, pipeline_depth=2, pipeline_depth_max=4, queue_max=0,
                deadline_ms=0, breaker_threshold=0, breaker_cooldown_ms=100)
    base.update(kw)
    return QueryCoalescer(**base)


def _tenant(das):
    return SimpleNamespace(das=das, lock=threading.RLock(), name="t")


def _poll(predicate, timeout=20.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if predicate():
            return True
        time.sleep(0.005)
    return False


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
def bio():
    data, genes, _ = build_bio_atomspace(**_BIO)
    names = [data.nodes[h].name for h in genes]
    return data, names


def _fresh(bio, **cfg):
    data, _ = bio
    return DistributedAtomSpace(backend="tensor", data=data, device="cpu",
                                config=DasConfig(**cfg))


def test_concurrent_submits_equal_serial(bio):
    das = _fresh(bio)
    _, names = bio
    queries = [_gene_query(g) for g in names[:24]]
    queries.append(Link("Member", [Variable("V1"), Variable("V2")], False))  # tree route
    want = [das.query(q) for q in queries]
    assert sum(bool(w) for w in want) >= 6
    reference = _reference_answers(
        _BIO, names[:24],
        extra=[lambda m: m.Link("Member", [m.Variable("V1"), m.Variable("V2")], False)])
    assert [_as_set(w) for w in want] == reference
    served = _fresh(bio)
    tenant = _tenant(served)
    coal = _coalescer()
    futs = [None] * (2 * len(queries))

    def client(k):
        for i in range(k, len(futs), 4):
            futs[i] = coal.submit(tenant, queries[i % len(queries)], HANDLE)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    got = [f.result(timeout=60) for f in futs]
    assert got == want + want
    assert [_as_set(g) for g in got] == reference + reference
    snap = coal.snapshot()
    assert snap["items"] == len(futs) and snap["batches"] < len(futs)
    assert snap["inflight_peak"] >= 1 and snap["max_batch"] > 1


def test_snapshot_keys_and_window_formula_equal_das_tpu():
    keys = set(_coalescer().snapshot())
    jkeys = set(JxCoalescer(max_batch=8, pipeline_depth=2, pipeline_depth_max=4, queue_max=0,
                            deadline_ms=0, breaker_threshold=0,
                            breaker_cooldown_ms=100).snapshot())
    assert keys == jkeys
    for rtt in (0.0, 0.5, 3.0, 40.0, 120.0):
        for disp in (0.0, 0.1, 1.0, 7.0):
            for floor, cap in ((1, 1), (2, 8), (3, 4)):
                assert (QueryCoalescer._depth_from(rtt, disp, floor, cap)
                        == JxCoalescer._depth_from(rtt, disp, floor, cap))
    cfg = DasConfig()
    bare = QueryCoalescer()
    assert (bare.max_batch, bare.pipeline_depth, bare.pipeline_depth_max, bare.queue_max,
            bare.deadline_ms, bare.breaker.failure_threshold, bare.breaker.cooldown_ms) == (
        cfg.coalesce_max_batch, cfg.pipeline_depth, cfg.pipeline_depth_max,
        cfg.coalesce_queue_max, cfg.query_deadline_ms, cfg.breaker_failure_threshold,
        float(cfg.breaker_cooldown_ms))


class _SlowDas:
    """A tenant store whose batch dispatch stalls and whose per-query path
    answers."""

    def __init__(self, dispatch_s):
        self.dispatch_s = dispatch_s
        self.config = DasConfig()

    def query_many_dispatch(self, queries, fmt, cache_only=False):
        time.sleep(self.dispatch_s)
        raise RuntimeError("no batch path")

    def query(self, q, fmt):
        return f"ans:{q}"


def test_deadline_expires_queued_grouped_and_inflight():
    das = _SlowDas(0.25)
    tenant = _tenant(das)
    coal = _coalescer(max_batch=1, pipeline_depth=1, pipeline_depth_max=1, deadline_ms=50)
    first = coal.submit(tenant, "q0", None)
    assert _poll(lambda: coal.stats["batches"] >= 1)
    late = [coal.submit(tenant, f"q{i}", None) for i in (1, 2, 3)]
    for fut in late:
        assert isinstance(fut.exception(timeout=30), DasDeadlineError)
    first_out = first.exception(timeout=30) or first.result(timeout=30)
    assert first_out == "ans:q0" or isinstance(first_out, DasDeadlineError)
    assert coal.stats["deadline_expired"] >= 3
    das.dispatch_s = 0.0
    assert coal.submit(tenant, "q9", None).result(timeout=30) == "ans:q9"

    # grouped: past its deadline when the group reaches dispatch
    coal = _coalescer(deadline_ms=10)
    fut = Future()
    entry = coal._dispatch_group(tenant, None,
                                 [(tenant, "q", None, fut, None, time.monotonic() - 0.01)])
    assert entry[3] is None and entry[2] == []
    assert isinstance(fut.exception(timeout=1), DasDeadlineError)
    # in flight: alive at dispatch, expired by settle: no fallback query
    fut2 = Future()
    entry = coal._dispatch_group(tenant, None,
                                 [(tenant, "q2", None, fut2, None, time.monotonic() + 0.02)])
    time.sleep(0.05)
    coal._settle_group(entry)
    assert isinstance(fut2.exception(timeout=1), DasDeadlineError)
    assert coal.stats["deadline_expired"] == 2


def test_backpressure_rejects_typed():
    das = _SlowDas(0.2)
    tenant = _tenant(das)
    coal = _coalescer(max_batch=1, pipeline_depth=1, pipeline_depth_max=1, queue_max=1)
    futs = [coal.submit(tenant, f"q{i}", None) for i in range(6)]
    outs = []
    for f in futs:
        exc = f.exception(timeout=30)
        outs.append(exc if exc is not None else f.result(timeout=30))
    rejected = [o for o in outs if isinstance(o, CoalescerSaturatedError)]
    assert rejected and all(isinstance(o, CoalescerSaturatedError) or o.startswith("ans:")
                            for o in outs)
    assert coal.snapshot()["queue_rejections"] == len(rejected)


class _FlakyDas:
    """A tenant store whose per-query path fails retryable on demand."""

    def __init__(self):
        self.mode = "fail"
        self.config = DasConfig()

    def query_many_dispatch(self, queries, fmt, cache_only=False):
        raise RuntimeError("no batch path")

    def query(self, q, fmt):
        if self.mode == "fail":
            raise InjectedFault("settle_fetch", 0)
        return f"ans:{q}"


def test_breaker_trips_rejects_and_recovers():
    das = _FlakyDas()
    tenant = _tenant(das)
    coal = _coalescer(max_batch=1, breaker_threshold=2, breaker_cooldown_ms=80)
    for name in ("a", "b"):
        assert isinstance(coal.submit(tenant, name, None).exception(timeout=30), InjectedFault)
    assert _poll(lambda: coal.stats["breaker_state"] == fault.OPEN)
    das.mode = "ok"
    exc = coal.submit(tenant, "c", None).exception(timeout=30)
    assert isinstance(exc, BreakerOpenError) and exc.retry_after_ms > 0
    assert coal.stats["effective_depth"] == 1
    time.sleep(0.1)  # past the cooldown: the next group is the probe
    assert coal.submit(tenant, "d", None).result(timeout=30) == "ans:d"
    assert _poll(lambda: coal.stats["breaker_state"] == fault.CLOSED)
    snap = coal.snapshot()
    assert (snap["breaker_trips"], snap["breaker_recoveries"]) == (1, 1)
    assert snap["breaker_rejections"] >= 1


def test_degraded_mode_serves_cache_hits(bio):
    das = _fresh(bio)
    _, names = bio
    tenant = _tenant(das)
    coal = _coalescer(breaker_threshold=1, breaker_cooldown_ms=60_000)
    q_hot, q_trip, q_cold = (_gene_query(g) for g in names[30:33])
    want_hot = das.query(q_hot)
    assert coal.submit(tenant, q_hot, HANDLE).result(timeout=60) == want_hot
    fault.configure("seed=4;sites=settle_fetch;every=1;max=1000")
    assert coal.submit(tenant, q_trip, HANDLE).result(timeout=60) == das.query(q_trip)
    fault.configure(None)
    assert _poll(lambda: coal.stats["breaker_state"] == fault.OPEN)
    from das_tpu_torch.query.fused import FETCH_COUNTS

    n0 = FETCH_COUNTS["n"]
    assert coal.submit(tenant, q_hot, HANDLE).result(timeout=60) == want_hot
    assert FETCH_COUNTS["n"] == n0  # answered from the cache, no device work
    exc = coal.submit(tenant, q_cold, HANDLE).exception(timeout=60)
    assert isinstance(exc, BreakerOpenError) and exc.retry_after_ms is not None


def test_commit_between_speculative_dispatch_and_settle(bio):
    data, names = build_bio_atomspace(**_BIO)[0], bio[1]
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu")
    gene = names[0]
    q = Link("Interacts", [Node("Gene", gene), Variable("V2")], True)
    before = das.query(q)
    job = das.query_many_dispatch([q, q])
    tx = das.open_transaction()
    tx.add(f'(: "{gene}" Gene)')
    tx.add('(: "GENE:new" Gene)')
    tx.add(f'(Interacts "{gene}" "GENE:new")')
    das.commit_transaction(tx)
    after = job.settle()
    new = das.db.get_node_handle("Gene", "GENE:new")
    assert new not in before and all(new in a for a in after)
    assert after == [das.query(q)] * 2
