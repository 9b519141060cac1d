"""The serving worker's own accounting in das_tpu_torch's recorder, and the
benchmark readers built on it:

  * `serve.idle` covers only the coalescer worker's blocking wait for
    work, nested in `serve.drain`, on the worker's named thread;
  * `serve.dispatch` carries its members' summed queue wait (`queue_s`)
    over those that carried a mark (`queued`);
  * `serve.settle` carries the worker thread's CPU seconds (`cpu_s`);
  * `exec.format` is one span per formatted answer, on the batch paths
    (fused and sharded) and the single-query path;
  * with tracing off none of these record and the thread CPU clock is
    never read;
  * the five readers of dasbench/metrics/ on a hand-built window, and on
    a program that records none of this (they report nothing);
  * obs/torchprof.py's merge of the recorder onto the profiler's clock,
    and chip_smoke.py's check of a merged trace's clock.

Everything runs on device="cpu"."""

import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import pytest

from das_tpu_torch import obs
from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.obs import torchprof
from das_tpu_torch.query.ast import And, Link, Node, Variable
from das_tpu_torch.service import coalesce
from das_tpu_torch.service.coalesce import QueryCoalescer
from das_tpu_torch.storage.atom_table import load_metta_text


@pytest.fixture(autouse=True)
def _clean():
    yield
    obs.set_context(None, 0)
    obs.reset()
    obs.configure(enabled=False)


def _das(backend="tensor"):
    cfg = DasConfig(mesh_shape=(4,)) if backend == "sharded" else None
    return DistributedAtomSpace(backend=backend, device="cpu", config=cfg,
                                data=load_metta_text(animals_metta()))


def _queries():
    mammal = Node("Concept", "mammal")
    return [Link("Inheritance", [Variable("V1"), mammal], True),
            And([Link("Inheritance", [Variable("V1"), mammal], True),
                 Link("Inheritance", [Variable("V1"), Variable("V2")], True)])]


def _coalescer():
    return QueryCoalescer(max_batch=8, pipeline_depth=2, pipeline_depth_max=4,
                          queue_max=0, deadline_ms=0, breaker_threshold=0,
                          breaker_cooldown_ms=100)


def _tenant(das):
    return SimpleNamespace(das=das, lock=threading.RLock(), name="animals")


def _spans(name):
    return [e for e in obs.events() if e[0] == name and e[1] == "X"]


# -- the program's spans --------------------------------------------------------


def test_idle_only_on_a_blocking_drain_nested_in_drain():
    obs.configure(enabled=True)
    das, qs = _das(), _queries()
    tenant, coal = _tenant(das), _coalescer()
    assert [f.result(timeout=30) for f in [coal.submit(tenant, q, QueryOutputFormat.HANDLE)
                                           for q in qs]]
    # the worker has settled everything and blocks for work
    time.sleep(0.05)
    assert coal.submit(tenant, qs[0], QueryOutputFormat.HANDLE).result(timeout=30)
    idles, drains = _spans("serve.idle"), _spans("serve.drain")
    assert idles and len(idles) <= len(drains)
    assert max(e[3] for e in idles) >= 0.02
    (worker,) = {e[7] for e in idles + drains}
    assert worker.startswith(coalesce.WORKER_THREAD + "-") and worker == coal._worker.name
    for _n, _ph, t0, dur, *_rest in idles:
        assert any(d[2] <= t0 and t0 + dur <= d[2] + d[3] for d in drains)
    # a non-blocking drain (the pipeline top-up) is no idle wait; a
    # blocking one is, even when the queue already holds work
    obs.reset()
    quiet = _coalescer()
    for q in qs:
        quiet._queue.put_nowait((tenant, q, QueryOutputFormat.HANDLE, Future(), None, None))
    assert len(quiet._drain(block=False, limit=1)) == 1
    assert _spans("serve.idle") == []
    assert len(quiet._drain(block=True)) == 1
    assert len(_spans("serve.idle")) == 1


def test_dispatch_carries_the_members_queue_wait():
    obs.configure(enabled=True)
    das, qs = _das(), _queries()
    tenant, coal = _tenant(das), _coalescer()
    t = time.perf_counter()
    marks = [(obs.new_trace(), t - 0.3), None, (obs.new_trace(), t - 0.1)]
    group = [(tenant, q, QueryOutputFormat.HANDLE, Future(), m, None)
             for q, m in zip(qs + qs[:1], marks)]
    entry = coal._dispatch_group(tenant, QueryOutputFormat.HANDLE, group)
    oldest = time.perf_counter() - (t - 0.3)
    (dispatch,) = _spans("serve.dispatch")
    attrs = dispatch[8]
    assert attrs["queued"] == 2
    assert 0.4 <= attrs["queue_s"] <= attrs["queued"] * oldest
    coal._settle_group(entry)
    assert all(item[3].result(timeout=30) is not None for item in group)
    (settle,) = _spans("serve.settle")
    assert 0.0 <= settle[8]["cpu_s"] <= settle[3] + 1e-3


@pytest.mark.parametrize("backend", ["tensor", "sharded"])
def test_format_once_per_answer_on_each_path(backend):
    das, qs = _das(backend), _queries()
    want = [len(das.query_answer(q)[1].assignments) for q in qs]
    obs.configure(enabled=True)
    das.query_many(qs)
    assert sorted(e[8]["answers"] for e in _spans("exec.format")) == sorted(want)
    obs.reset()
    das.query(qs[1], QueryOutputFormat.JSON)
    (fmt,) = _spans("exec.format")
    assert fmt[8] == {"answers": want[1], "format": "JSON"}


def test_off_records_nothing_and_reads_no_cpu_clock(monkeypatch):
    def boom():
        raise AssertionError("time.thread_time read with tracing off")

    monkeypatch.setattr(coalesce.time, "thread_time", boom)
    das, qs = _das(), _queries()
    tenant, coal = _tenant(das), _coalescer()
    futs = [coal.submit(tenant, q, QueryOutputFormat.HANDLE) for q in qs + qs]
    assert all(f.result(timeout=30) for f in futs)
    das.query_many(qs)
    das.query(qs[0])
    assert obs.events() == []


# -- the benchmark's readers ----------------------------------------------------

#: two coalescer workers
W1, W2 = "das-coalescer-1", "das-coalescer-2"


def _window(spans, completed=20):
    from dasbench.trace import Observed

    return SimpleNamespace(observed=Observed(window_s=10.0, t_start=100.0, t_end=110.0,
                                             completed=completed, spans=spans))


def _x(name, t0, t1, thread=W1, **attrs):
    return (name, "X", t0, t1 - t0, thread, attrs)


#: a window [100, 110]: each worker's spans nest as a thread's do, and some
#: cross the window's edges
SPANS = [
    _x("exec.format", 98.0, 98.05),
    _x("serve.dispatch", 98.5, 98.7, queue_s=9.0, queued=3),
    _x("serve.drain", 99.0, 101.0), _x("serve.idle", 99.5, 100.8),
    _x("serve.dispatch", 101.0, 101.1, queue_s=0.3, queued=2),
    # settle S2: children cover 0.7, one nested in another; a client
    # thread's span over it does not count
    _x("serve.settle", 102.0, 103.0, cpu_s=0.9),
    _x("exec.settle_fetch", 102.0, 102.2), _x("exec.materialize", 102.2, 102.6),
    _x("exec.dispatch", 102.3, 102.4), _x("exec.format", 102.6, 102.7),
    _x("exec.materialize", 102.0, 103.0, thread="rpc-2"),
    _x("serve.drain", 104.9, 105.3), _x("serve.idle", 105.0, 105.2),
    _x("serve.dispatch", 106.0, 106.1, queue_s=0.5, queued=3),
    _x("serve.dispatch", 107.0, 107.1),
    _x("serve.drain", 107.5, 108.0), _x("serve.idle", 107.6, 107.7),
    # settle S3 crosses the end: [109.5, 110], children cover 0.3
    _x("serve.settle", 109.5, 110.4, cpu_s=0.6),
    _x("exec.materialize", 109.6, 109.8), _x("exec.format", 109.9, 110.2),
    # the second worker: settle S1 crosses the start, [100, 100.6], its
    # children cover 0.3; a dispatch that starts in the window and ends
    # past it
    _x("serve.settle", 99.8, 100.6, thread=W2, cpu_s=0.7),
    _x("exec.settle_fetch", 99.85, 99.95, thread=W2),
    _x("exec.materialize", 100.1, 100.3, thread=W2),
    _x("exec.format", 100.3, 100.4, thread=W2),
    _x("serve.dispatch", 109.99, 110.2, thread=W2, queue_s=0.2, queued=1),
    ("serve.answer", "i", 101.0, 0.0, W1, {}),
]

KNOWN = {
    # idle 0.8 + 0.2 + 0.1 on the worker of 10 s
    "service.worker_idle_share": 11.0,
    # (0.3 + 0.5 + 0.2) s over 6 queries
    "service.queue_ms": 1e3 / 6,
    # self 0.3 + 0.3 + 0.2 of 10 s
    "service.settle_self_share": 8.0,
    # S2 and S3 start in the window: (0.9 + 0.6) / (1.0 + 0.9)
    "service.settle_cpu_share": 100.0 * 1.5 / 1.9,
    # 0.1 + 0.1 + 0.1 s over 20 answers
    "exec.format_ms": 15.0,
}


def _reader(name):
    from dasbench import run

    return run.load_path(run.HERE / "metrics" / f"{name}.py", f"dasbench_metric_{name}")


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_returns_the_known_value(name):
    assert _reader(name).read(_window(SPANS)) == pytest.approx(KNOWN[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_reports_nothing_without_the_accounting(name):
    """A program that records none of these spans, attributes or the
    worker's thread name: the readers report nothing and do not raise."""
    older = [(n, ph, t0, d, "Thread-3", {k: v for k, v in a.items()
                                          if k not in ("cpu_s", "queue_s", "queued")})
             for n, ph, t0, d, _th, a in SPANS if n not in ("serve.idle", "exec.format")]
    assert _reader(name).read(_window(older)) is None
    assert _reader(name).read(_window([], completed=0)) is None


def test_idle_reader_takes_the_worker_name_from_the_program(monkeypatch):
    """The reader picks the worker's spans by the program's own thread
    name: renamed, or absent (an older program), it reports nothing."""
    reader = _reader("service.worker_idle_share")
    monkeypatch.setattr(coalesce, "WORKER_THREAD", "das-worker")
    assert reader.read(_window(SPANS)) is None
    monkeypatch.delattr(coalesce, "WORKER_THREAD")
    assert reader.read(_window(SPANS)) is None


# -- one trace on one clock ----------------------------------------------------


def _profile(marker_kernel="void at::cuda::(anonymous namespace)::spin_kernel(long)"):
    return {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 900.0, "dur": 5.0,
         "pid": 4242, "tid": 4242},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1000.0,
         "dur": 4.0, "pid": 4242, "tid": 4242, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": marker_kernel, "ts": 1010.0, "dur": 1000.0,
         "pid": 0, "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "pr_terms_kernel(PrTerms)", "ts": 3000.0,
         "dur": 3.0, "pid": 0, "tid": 7, "args": {"correlation": 9}},
    ]}


def test_merge_shifts_the_recorder_onto_the_profiler_clock():
    rec = obs.TraceRecorder(enabled=True)
    rec.set_context("tenantA", 3)
    rec.record("serve.dispatch", "X", rec._t_origin + 0.25, 0.002, 0, {"queued": 2})
    rec.record("serve.submit", "i", rec._t_origin + 0.2495, 0.0, 5, {})
    trace = _profile()
    # the marker launched 0.2495 s after the recorder's origin
    assert torchprof.marker_launch_us(trace["traceEvents"]) == 1002.0
    assert torchprof.merge_recorder(trace, rec.events(), 0.2495)
    events = trace["traceEvents"]
    assert events[:4] == _profile()["traceEvents"]
    merged = {e["name"]: e for e in events[4:]}
    assert merged["serve.dispatch"]["ts"] == pytest.approx(1502.0)
    assert merged["serve.dispatch"]["dur"] == pytest.approx(2000.0)
    assert merged["serve.submit"]["ts"] == pytest.approx(1002.0)
    # the recorder's lanes keep pids of their own, past any the profiler uses
    assert {e["pid"] for e in events[4:]} >= {torchprof.OBS_PID_BASE + 1}
    assert min(e["pid"] for e in events[4:]) > torchprof.OBS_PID_BASE
    lanes = {e["args"]["name"] for e in events[4:] if e["name"] == "process_name"}
    assert lanes == {"tenantA"}


def test_merge_without_a_runtime_call_or_a_marker():
    trace = _profile()
    del trace["traceEvents"][1]
    # the marker kernel's own start stands in for its launch
    assert torchprof.marker_launch_us(trace["traceEvents"]) == 1010.0
    plain = _profile("pr_terms_kernel(PrTerms)")
    assert torchprof.marker_launch_us(plain["traceEvents"]) is None
    assert not torchprof.merge_recorder(plain, [("serve.idle", "X", 0.1, 0.1, 0, 0, None,
                                                 W1, {})], 0.0)
    assert plain == _profile("pr_terms_kernel(PrTerms)")


def _merged(shift_us=0.0):
    """A merged trace: the worker (host thread 11) launches one kernel in a
    serve.dispatch and one copy in a serve.settle, a client thread (12)
    one kernel outside both; the recorder's spans moved by `shift_us`."""

    def call(ts, tid, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 4.0, "pid": 40, "tid": tid, "args": {"correlation": corr}}

    def work(ts, corr, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": 3.0, "pid": 0,
                "tid": 7, "args": {"correlation": corr}}

    def span(name, ts, dur):
        return {"ph": "X", "name": name, "ts": ts + shift_us, "dur": dur,
                "pid": torchprof.OBS_PID_BASE + 1, "tid": 2, "args": {}}

    return [call(1000.0, 11, 1), work(1010.0, 1), call(1500.0, 11, 2),
            work(1600.0, 2, "gpu_memcpy"), call(3000.0, 12, 3), work(3005.0, 3),
            {"ph": "M", "name": "process_name", "pid": "Spans", "tid": 0, "args": {}},
            {"ph": "M", "name": "process_name", "pid": torchprof.OBS_PID_BASE + 1, "tid": 0,
             "args": {"name": "tenant"}},
            span("serve.dispatch", 990.0, 110.0), span("serve.settle", 1400.0, 300.0)]


def test_chip_smoke_reads_a_merged_trace():
    import chip_smoke

    prof, rec = chip_smoke.split_merged_trace(_merged())
    assert [e["name"] for e in rec] == ["process_name", "serve.dispatch", "serve.settle"]
    assert len(prof) == 7
    assert chip_smoke.check_one_clock(_merged()) == {"dispatch_launches": 1,
                                                     "nearest_lead_us": 20.0}


@pytest.mark.parametrize("shift_us", [-500.0, 200.0, 5000.0])
def test_chip_smoke_refuses_a_merged_trace_off_its_clock(shift_us):
    import chip_smoke

    with pytest.raises(AssertionError, match="merged trace"):
        chip_smoke.check_one_clock(_merged(shift_us))
