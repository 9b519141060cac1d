"""Optional torch.profiler integration (port of `das_tpu/obs/jaxprof.py`):
named host scopes, and one trace that holds the program's spans and the
card's timeline on one clock.

With `obs.configure(annotations=True)`, `annotation(name)` wraps a block
in `torch.profiler.record_function(name)`: the dispatch and settle-fetch
halves use it, so a captured trace shows which host dispatch launched
which kernels and where the settle fetch sat against them.  Off (the
default) it returns the shared no-op span: no allocation and no profiler
call, the recorder's off-path contract.

`maybe_start_trace(config)` / `maybe_stop_trace()` run a
`torch.profiler.profile` over the CPU (and CUDA where a card is at hand)
and write it as a Chrome trace into `DasConfig.profiler_trace_dir`.  On a
card the start launches a marker kernel (`torch.cuda._sleep`) at a known
`time.perf_counter`, and the stop merges the obs recorder's events into
the same file, shifted onto the profiler's clock by that marker
(`merge_recorder`): turn on `obs.configure(enabled=True)`, set the field,
run the workload, and the one file shows the worker's spans over the
CUDA stream.  Without a card the file is the profiler's trace alone."""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import torch

from das_tpu_torch.obs.export import chrome_trace
from das_tpu_torch.obs.recorder import NOOP_SPAN

#: obs.configure(annotations=) sets it
_GATE = {"on": False}
#: the running profile, its directory, the marker's host time (perf_counter
#: seconds, None without a card) and the last trace file written
_STATE = {"prof": None, "dir": None, "marker": None, "last": None, "n": 0}

#: the recorder's lanes become these Chrome-trace pids and up: past any
#: Linux pid (at most 2**22) and any device index the profiler uses
OBS_PID_BASE = 1 << 24


def configure(annotations: Optional[bool] = None) -> None:
    if annotations is not None:
        _GATE["on"] = bool(annotations)


def annotation(name: str):
    """A torch.profiler.record_function scope when annotations are on,
    else the shared no-op context.  Names are obs/registry.py members, so
    the host trace and the profiler trace share their vocabulary."""
    if not _GATE["on"]:
        return NOOP_SPAN
    return torch.profiler.record_function(name)


def _launch_marker() -> float:
    """Launch the marker kernel on an idle card; the host perf_counter at
    the middle of its launch call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(1000)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t0 + t1) / 2


def maybe_start_trace(config=None) -> bool:
    """Start a profile into `config.profiler_trace_dir` when one is set (a
    second call with a profile running does nothing); on a card, launch
    the marker that ties the recorder's clock to the profiler's.  True
    when a profile is running."""
    trace_dir = getattr(config, "profiler_trace_dir", None)
    if not trace_dir:
        return False
    if _STATE["prof"] is not None:
        return True
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _STATE["prof"], _STATE["dir"] = prof, trace_dir
    _STATE["marker"] = _launch_marker() if cuda else None
    return True


def marker_launch_us(trace_events: List[dict]) -> Optional[float]:
    """The profiler-clock time (us) of the marker's launch: the middle of
    the runtime call that launched the earliest sleep kernel, or that
    kernel's own start when the runtime call is missing; None when the
    trace holds no marker."""
    marker = [e for e in trace_events if e.get("ph") == "X" and e.get("cat") == "kernel"
              and ("sleep" in e.get("name", "") or "spin" in e.get("name", ""))]
    if not marker:
        return None
    m = min(marker, key=lambda e: float(e["ts"]))
    corr = (m.get("args") or {}).get("correlation")
    for e in trace_events:
        if (e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and corr is not None
                and (e.get("args") or {}).get("correlation") == corr):
            return float(e["ts"]) + float(e.get("dur", 0.0)) / 2
    return float(m["ts"])


def merge_recorder(trace: dict, events: List[tuple], marker_rel_s: float) -> bool:
    """Append the recorder's `events` (obs.events(), seconds from the
    recorder's origin) to the profiler's Chrome `trace`, shifted onto its
    clock: shift = the marker's launch on the profiler's clock minus the
    marker's host time from the recorder's origin (`marker_rel_s`).  The
    recorder's lanes keep their own pids, from OBS_PID_BASE.  False, and
    `trace` untouched, when it holds no marker."""
    base = trace.get("traceEvents", [])
    launch_us = marker_launch_us(base)
    if launch_us is None:
        return False
    shift_us = launch_us - marker_rel_s * 1e6
    merged = chrome_trace(events)["traceEvents"]
    for e in merged:
        e["pid"] += OBS_PID_BASE
        if e["ph"] != "M":
            e["ts"] = round(e["ts"] + shift_us, 3)
    trace["traceEvents"] = base + merged
    return True


def maybe_stop_trace() -> bool:
    """Stop the running profile, if any, and write its Chrome trace into
    the directory it was started with (`last_trace_path()`), with the
    recorder's events merged onto the profiler's clock when a marker ran."""
    prof = _STATE["prof"]
    if prof is None:
        return False
    prof.stop()
    os.makedirs(_STATE["dir"], exist_ok=True)
    _STATE["n"] += 1
    path = os.path.join(_STATE["dir"], f"das_tpu_torch_{os.getpid()}_{_STATE['n']}.trace.json")
    prof.export_chrome_trace(path)
    if _STATE["marker"] is not None:
        from das_tpu_torch import obs

        with open(path) as f:
            trace = json.load(f)
        if merge_recorder(trace, obs.events(), _STATE["marker"] - obs.REC._t_origin):
            with open(path, "w") as f:
                json.dump(trace, f)
    _STATE["prof"], _STATE["dir"], _STATE["marker"], _STATE["last"] = None, None, None, path
    return True


def last_trace_path() -> Optional[str]:
    """The file the last maybe_stop_trace wrote."""
    return _STATE["last"]
