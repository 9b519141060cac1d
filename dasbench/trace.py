"""What a `--trace 1` run records over its window, for the per-layer
readers of `dasbench/metrics/`.

* the program's spans and counters (`das_tpu_torch.obs`, switched on with
  its `torch.profiler` scopes), the coalescer's counters and the kernel
  and fetch counts (`LAUNCH_COUNTS`, `FETCH_COUNTS`), as deltas over the
  window;
* every call of the five kernel wrappers, with its host interval and the
  tensors it took and gave, from which `roofline.work_of` counts its bytes
  and operations once the window has closed;
* the card's activity from `torch.profiler` (CUDA activity only: the host
  side of the program is in the spans), read from its Chrome trace.

The device clock is tied to `time.perf_counter` by a marker: the profiler
sees the CUDA runtime call that launches a sleep kernel issued at a known
host time, on an idle card.
"""

from __future__ import annotations

import bisect
import gc
import json
import math
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dasbench import roofline

#: obs ring bound for a window (the default ring of 65,536 events drops
#: the oldest within seconds at these rates)
RING = 1 << 22


@dataclass
class Observed:
    """What a traced window leaves for the readers."""

    window_s: float
    t_start: float
    t_end: float
    completed: int                      # requests answered inside the window
    #: obs events (name, phase, perf_counter start, seconds, thread, attrs)
    spans: List[tuple] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    serving: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    fetches: int = 0
    calls: List[dict] = field(default_factory=list)     # kernel wrapper calls
    device: List[dict] = field(default_factory=list)    # device activity
    busy_s: Optional[float] = None
    #: the interpreter's garbage collections (start, end, generation)
    gc_pauses: List[tuple] = field(default_factory=list)


class KernelCalls:
    """Wraps the five kernel wrappers of `das_tpu_torch.kernels` so each
    call records (kernel, host start, host end, args, kw, out)."""

    def __init__(self):
        self.calls: List[list] = []
        self._saved = {}

    def __enter__(self):
        from das_tpu_torch import kernels

        for name, attr in roofline.WRAPPERS.items():
            self._saved[attr] = fn = getattr(kernels, attr)

            def rec(*a, _name=name, _fn=fn, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                self.calls.append([_name, t0, time.perf_counter(), a, kw, out])
                return out

            setattr(kernels, attr, rec)
        return self

    def __exit__(self, *_exc):
        from das_tpu_torch import kernels

        for attr, fn in self._saved.items():
            setattr(kernels, attr, fn)
        return False

    def work(self) -> List[dict]:
        """Each call's bytes and operations (reading the counts it
        produced, so after the card has finished), dropping its tensors;
        a call the byte functions cannot count is printed, not skipped."""
        out = []
        for name, t0, t1, a, kw, res in self.calls:
            try:
                n_bytes, n_ops = roofline.work_of(name, a, kw, res)
            except (KeyError, TypeError, ValueError, IndexError) as exc:
                print(f"dasbench: {name} call outside the byte model ({exc!r}); "
                      "it has no least time", flush=True)
                n_bytes = n_ops = None
            out.append({"kernel": name, "t0": t0, "t1": t1, "bytes": n_bytes, "ops": n_ops})
        self.calls = []
        return out


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.marker_host = None

    def start(self):
        torch = self.torch
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> List[dict]:
        """Device activity as dicts (name, cat, start and end on the host's
        perf_counter clock, the launch's host time where the runtime call
        was seen)."""
        self.torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return to_host_clock(events, self.marker_host)


def to_host_clock(events, marker_host: float) -> List[dict]:
    """Kernel, memcpy and memset events with times in perf_counter seconds;
    the offset comes from the marker sleep kernel's launch (its runtime
    call, or failing that the kernel's own start)."""
    launches = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("ph") == "X":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    marker = [e for e in device if "sleep" in e.get("name", "") or "spin" in e.get("name", "")]
    if not marker:
        print("dasbench: the profiler trace lacks the marker kernel; device times are "
              "not tied to the host clock", flush=True)
        return []
    m = min(marker, key=lambda e: float(e["ts"]))
    corr = (m.get("args") or {}).get("correlation")
    base = launches.get(corr, float(m["ts"]))
    offset_us = base - marker_host * 1e6
    out = []
    for e in device:
        if e is m:
            continue
        start = (float(e["ts"]) - offset_us) / 1e6
        corr = (e.get("args") or {}).get("correlation")
        launch = launches.get(corr)
        out.append({"name": e.get("name", ""), "cat": e["cat"], "start": start,
                    "end": start + float(e.get("dur", 0.0)) / 1e6,
                    "launch": None if launch is None else (launch - offset_us) / 1e6})
    return out


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """(start, end) of every stretch of [lo, hi] with no device activity."""
    gaps, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def attribute(calls: List[dict], device: List[dict]) -> None:
    """Give each kernel event of the five kernels the wrapper call whose
    host interval holds its launch (`event["call"]`, an index into
    `calls`), or None."""
    starts = [c["t0"] for c in calls]
    for e in device:
        e["call"] = None
        if e["cat"] != "kernel" or not is_das_kernel(e["name"]) or e["launch"] is None:
            continue
        k = bisect.bisect_right(starts, e["launch"]) - 1
        if k >= 0 and calls[k]["t0"] <= e["launch"] <= calls[k]["t1"]:
            e["call"] = k


_DAS_KERNEL = re.compile(r"(?:^|::|\s)(?:" + "|".join(roofline.KERNEL_PREFIXES) + r")\w*\(")


def is_das_kernel(name: str) -> bool:
    """A kernel of das_tpu_torch/kernels/csrc/, by its demangled name
    (`pr_terms_kernel(PrTerms)`, `(anonymous namespace)::jt_block_kernel(...)`)."""
    return _DAS_KERNEL.search(name) is not None


class GcPauses:
    """The interpreter's garbage collections over the window, through
    `gc.callbacks` (the harness watches the process; it changes nothing).
    Every collection is counted and timed by generation; those of
    `KEEP_S` or more are kept with their times, for the gaps they explain
    and the rate they cost over the window."""

    KEEP_S = 1e-3

    def __init__(self):
        self.pauses: List[tuple] = []
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            t1, gen = time.perf_counter(), info["generation"]
            self.count[gen] += 1
            self.seconds[gen] += t1 - self._t0
            if t1 - self._t0 >= self.KEEP_S:
                self.pauses.append((self._t0, t1, gen))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *_exc):
        gc.callbacks.remove(self)
        return False

    def summary(self, t_start: float, t_end: float, step: float) -> dict:
        """Count and seconds of each generation's collections, and the
        seconds of full (generation 2) collections in each `step` of the
        window."""
        per = [0.0] * max(1, math.ceil(round((t_end - t_start) / step, 6)))
        for g0, g1, gen in self.pauses:
            if gen == 2 and t_start <= g0 < t_end:
                per[min(len(per) - 1, int((g0 - t_start) / step))] += g1 - g0
        out = {f"gen{g}": [self.count[g], self.seconds[g]] for g in range(3)}
        out["gen2_s_per_step"] = per
        return out


class Session:
    """Everything a traced window records, started just before the window
    and stopped just after it."""

    def __init__(self, driver, cuda: bool = True):
        from das_tpu_torch import obs
        from das_tpu_torch.kernels import LAUNCH_COUNTS
        from das_tpu_torch.query.fused import FETCH_COUNTS

        self.obs, self.launch_counts, self.fetch_counts = obs, LAUNCH_COUNTS, FETCH_COUNTS
        self.driver = driver
        self.kernels = KernelCalls()
        #: no card (the CPU tests): no device trace, and no device metric
        self.devtrace = DeviceTrace() if cuda else None

    def _counters(self):
        from das_tpu_torch.obs import metrics

        return {name: c.value for name, c in metrics.COUNTERS.items()}

    def start(self):
        self.obs.configure(enabled=True, capacity=RING, annotations=True)
        self.obs.reset()
        self.origin = self.obs.REC._t_origin
        self.serving0 = self.driver.stats()
        self.launches0 = dict(self.launch_counts)
        self.fetches0 = self.fetch_counts["n"]
        self.counters0 = self._counters()
        if self.devtrace is not None:
            self.devtrace.start()
        self.kernels.__enter__()

    def stop(self, observed: Observed) -> None:
        self.kernels.__exit__()
        observed.device = self.devtrace.stop() if self.devtrace is not None else []
        serving = self.driver.stats()
        observed.serving = {k: serving[k] - self.serving0[k] for k in ("batches", "items")}
        observed.launches = {k: v - self.launches0.get(k, 0)
                             for k, v in self.launch_counts.items()}
        observed.fetches = self.fetch_counts["n"] - self.fetches0
        counters = self._counters()
        observed.counters = {k: counters[k] - self.counters0.get(k, 0) for k in counters}
        observed.spans = [(name, ph, t0 + self.origin, dur, thread, attrs)
                          for name, ph, t0, dur, _trace, _g, _lane, thread, attrs
                          in self.obs.events()]
        self.obs.configure(enabled=False, annotations=False)
        observed.calls = self.kernels.work()
        attribute(observed.calls, observed.device)
        if self.devtrace is not None:
            observed.busy_s = union_s([(e["start"], e["end"]) for e in observed.device],
                                      observed.t_start, observed.t_end)


def host_at(observed, a: float, b: float) -> str:
    """What the host was doing over the idle stretch [a, b]: the innermost
    span open at its middle (the coalescer worker records every span), or
    "no span"; prefixed "gc.genN in" when a garbage collection ran through
    a third or more of the stretch."""
    t = (a + b) / 2
    best = None
    for name, ph, t0, dur, _thread, _attrs in observed.spans:
        if ph == "X" and t0 <= t <= t0 + dur and (best is None or dur < best[1]):
            best = (name, dur)
    label = best[0] if best else "no span"
    for g0, g1, gen in observed.gc_pauses:
        if min(b, g1) - max(a, g0) >= (b - a) / 3:
            return f"gc.gen{gen} in {label}"
    return label


def breakdown(observed: Observed) -> dict:
    """The ten device operations that took the most time, and the ten
    longest idle gaps labelled with the span open at their middle."""
    by_name: Dict[str, float] = {}
    for e in observed.device:
        if e["end"] > observed.t_start and e["start"] < observed.t_end:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["end"] - e["start"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_gaps([(e["start"], e["end"]) for e in observed.device],
                     observed.t_start, observed.t_end)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_at(observed, a, b), b - a] for a, b in gaps]}


def unknown_kernels(observed: Observed) -> List[str]:
    """Device kernels in the window that are neither the port's nor
    PyTorch's own nor the marker."""
    out = set()
    for e in observed.device:
        n = e["name"]
        if e["cat"] == "kernel" and not is_das_kernel(n) and "at::" not in n \
                and "cub" not in n and "sleep" not in n and "spin" not in n:
            out.add(n)
    return sorted(out)

