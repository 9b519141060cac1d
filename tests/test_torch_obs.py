"""The port's trace and metric layer (das_tpu_torch/obs/) against das_tpu's
(das_tpu/obs/): the declared names (das_tpu's minus its XLA program
ledger's `prof.*`), the log-bucket histogram and its percentiles on the
same seeded samples, and the Chrome-trace and Prometheus text of the same
recorded events and metrics.  Then the port's own contract: off by default
and configured only through `obs.configure` (no environment
variable), a disabled path that records nothing, and a traced serving
round whose spans cover the lifecycle."""

import json

import numpy as np
import pytest

from das_tpu import obs as jx_obs
from das_tpu.obs import export as jx_export
from das_tpu.obs import metrics as jx_metrics
from das_tpu.obs import registry as jx_registry
from das_tpu_torch import fault, obs
from das_tpu_torch.obs import export, metrics, recorder, registry


@pytest.fixture(autouse=True)
def _clean():
    """No plan or recorder state leaks into the next test of the worker."""
    yield
    fault.configure(None)
    fault.reset_counts()
    obs.reset()
    obs.configure(enabled=False, capacity=recorder.DEFAULT_RING)
    jx_obs.reset()


def test_registry_equals_das_tpu_minus_prof():
    """The port's registry equals das_tpu's; from the program ledger's port
    on that includes its prof.* names, which were the difference before."""
    assert registry.SPAN_NAMES == jx_registry.SPAN_NAMES
    assert registry.COUNTER_NAMES == jx_registry.COUNTER_NAMES
    assert registry.HISTOGRAM_NAMES == jx_registry.HISTOGRAM_NAMES
    assert set(metrics.COUNTERS) == set(registry.COUNTER_NAMES)
    assert set(metrics.HISTOGRAMS) == set(registry.HISTOGRAM_NAMES)
    assert obs.counter("prof.compiles") is metrics.COUNTERS["prof.compiles"]
    with pytest.raises(KeyError):
        obs.counter("prof.compile")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_buckets_and_percentiles_equal(seed):
    rng = np.random.default_rng(seed)
    samples = np.concatenate([rng.lognormal(0.0, 2.0, 500), [0.0, 1e-4, 1e-3, 5e7]])
    for ms in samples:
        assert metrics.bucket_index(float(ms)) == jx_metrics.bucket_index(float(ms))
    for i in range(0, 128, 7):
        assert metrics.bucket_upper(i) == jx_metrics.bucket_upper(i)
    h, jh = metrics.Histogram("x"), jx_metrics.Histogram("x")
    assert h.percentiles() == jh.percentiles() == {"p50": None, "p95": None, "p99": None}
    for ms in samples:
        h.observe(float(ms))
        jh.observe(float(ms))
    assert h.counts == jh.counts
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.percentile(q) == jh.percentile(q)
    assert h.percentiles() == jh.percentiles()
    assert h.nonzero_buckets() == jh.nonzero_buckets()


def _script(rec):
    """The same recorded events through a recorder of either package."""
    rec.set_context("tenantA", 3)
    with rec.span("serve.dispatch", 7, queries=4, speculative=False) as sp:
        sp.set(degraded=False)
    rec.event("cache.hit", 0, count=12)
    rec.set_context(None, 0)
    rec.event("serve.answer", 7, error=False)
    rec.record("exec.settle_fetch", "X", 1.5, 0.25, 0, {"jobs": 2})


def test_chrome_trace_equals_das_tpu():
    rec = recorder.TraceRecorder(enabled=True)
    jrec = jx_obs.TraceRecorder(enabled=True)
    _script(rec)
    _script(jrec)
    # the timestamps differ; everything else must agree
    fixed = [(n, ph, 0.001 * i, 0.0005 if ph == "X" else 0.0, tr, g, ln, "T", a)
             for i, (n, ph, _t, _d, tr, g, ln, _th, a) in enumerate(rec.events())]
    jfixed = [(n, ph, 0.001 * i, 0.0005 if ph == "X" else 0.0, tr, g, ln, "T", a)
              for i, (n, ph, _t, _d, tr, g, ln, _th, a) in enumerate(jrec.events())]
    assert fixed == jfixed
    assert (json.dumps(export.chrome_trace(fixed), sort_keys=True)
            == json.dumps(jx_export.chrome_trace(jfixed), sort_keys=True))
    lanes = {e["args"]["name"] for e in export.chrome_trace(fixed)["traceEvents"]
             if e["name"] == "process_name"}
    assert lanes == {"tenantA", "das_tpu"}


def test_prometheus_text_equals_das_tpu():
    metrics.reset_metrics()
    jx_metrics.reset_metrics()
    for mod in (metrics, jx_metrics):
        mod.counter("serve.submitted").inc(5)
        mod.counter("fault.retries").inc(2)
        for ms in (0.4, 3.0, 3.1, 250.0):
            mod.histogram("serve.answer_ms").observe(ms)
    gauges = {"serving.batches": 3.0, "durability.generation": 1.0}
    text = export.prometheus_text(extra_gauges=gauges)
    jtext = jx_export.prometheus_text(extra_gauges=gauges)
    # the program ledger's prof.* series included
    assert text.splitlines() == jtext.splitlines()
    assert "das_tpu_obs_serve_submitted_total 5" in text
    assert 'das_tpu_obs_serve_answer_ms_bucket{le="+Inf"} 4' in text


def test_off_by_default_and_no_environment(monkeypatch):
    monkeypatch.setenv("DAS_TPU_TRACE", "1")
    monkeypatch.setenv("DAS_TPU_TRACE_RING", "32")
    rec = recorder.TraceRecorder()
    assert rec.enabled is False and rec.capacity == recorder.DEFAULT_RING
    assert obs.span("serve.plan") is obs.NOOP_SPAN
    assert obs.mark() is None and obs.new_trace() == 0
    obs.event("cache.hit")
    assert obs.events() == []
    obs.configure(enabled=True, capacity=20)
    assert obs.REC.capacity == 20 and obs.mark() is not None
    for _ in range(30):
        obs.event("cache.miss")
    assert len(obs.events()) == 20


def _animals_pair(**cfg):
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.storage.atom_table import load_metta_text

    return DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                                device="cpu", config=DasConfig(**cfg))


def _queries():
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    mammal = Node("Concept", "mammal")
    return [Link("Inheritance", [Variable("V1"), mammal], True),
            And([Link("Inheritance", [Variable("V1"), mammal], True),
                 Link("Inheritance", [Variable("V1"), Variable("V2")], True)])]


def test_disabled_path_records_nothing():
    das = _animals_pair()
    qs = _queries()
    das.query_many(qs + qs)
    das.query(qs[0])
    assert obs.events() == []
    assert all(c.value == 0 for c in metrics.COUNTERS.values())


def test_traced_round_covers_the_lifecycle():
    import threading
    from types import SimpleNamespace

    from das_tpu_torch.api.atomspace import QueryOutputFormat
    from das_tpu_torch.service.coalesce import QueryCoalescer

    obs.configure(enabled=True)
    das = _animals_pair(use_planner="auto")
    qs = _queries()
    want = [das.query(q) for q in qs]
    tenant = SimpleNamespace(das=das, lock=threading.RLock(), name="animals")
    coal = QueryCoalescer(max_batch=8, pipeline_depth=2, pipeline_depth_max=4,
                          queue_max=0, deadline_ms=0, breaker_threshold=0,
                          breaker_cooldown_ms=100)
    futs = [coal.submit(tenant, q, QueryOutputFormat.HANDLE) for q in qs + qs]
    assert [f.result(timeout=30) for f in futs] == want + want
    tx = das.open_transaction()
    tx.add('(: "lion" Concept)')
    tx.add('(Inheritance "lion" "mammal")')
    das.commit_transaction(tx)
    das.query_many(qs)  # the first cache access after the commit invalidates
    names = {e[0] for e in obs.events()}
    for name in ("serve.submit", "serve.drain", "serve.group", "serve.plan",
                 "serve.dispatch", "serve.settle", "serve.answer", "exec.dispatch",
                 "exec.settle_fetch", "exec.materialize", "cache.miss",
                 "planner.observe", "commit.delta", "cache.invalidate"):
        assert name in names, name
    assert names <= set(registry.SPAN_NAMES)
    assert obs.counter("serve.answers").value == len(futs)
    assert obs.histogram("serve.answer_ms").total == len(futs)
    lanes = {e["args"]["name"] for e in obs.chrome_trace(obs.events())["traceEvents"]
             if e["name"] == "process_name"}
    assert "animals" in lanes
