"""Optional torch.profiler integration (port of `das_tpu/obs/jaxprof.py`):
named host scopes that the card's timeline can be lined up against.

With `obs.configure(annotations=True)`, `annotation(name)` wraps a block
in `torch.profiler.record_function(name)`: the dispatch and settle-fetch
halves use it, so a captured trace shows which host dispatch launched
which kernels and where the settle fetch sat against them.  Off (the
default) it returns the shared no-op span: no allocation and no profiler
call, the recorder's off-path contract.

`maybe_start_trace(config)` / `maybe_stop_trace()` run a
`torch.profiler.profile` over the CPU (and CUDA where a card is at hand)
and write it as a Chrome trace into `DasConfig.profiler_trace_dir`:
turn on `obs.configure(enabled=True, annotations=True)`, set the field,
run the workload, then open the obs trace and this trace side by side."""

from __future__ import annotations

import os
from typing import Optional

import torch

from das_tpu_torch.obs.recorder import NOOP_SPAN

#: obs.configure(annotations=) sets it
_GATE = {"on": False}
#: the running profile, its directory, and the last trace file written
_STATE = {"prof": None, "dir": None, "last": None, "n": 0}


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


def maybe_start_trace(config=None) -> bool:
    """Start a profile into `config.profiler_trace_dir` when one is set (a
    second call with a profile running does nothing).  True when a profile
    is running."""
    trace_dir = getattr(config, "profiler_trace_dir", None)
    if not trace_dir:
        return False
    if _STATE["prof"] is not None:
        return True
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _STATE["prof"], _STATE["dir"] = prof, trace_dir
    return True


def maybe_stop_trace() -> bool:
    """Stop the running profile, if any, and write its Chrome trace into
    the directory it was started with (`last_trace_path()`)."""
    prof = _STATE["prof"]
    if prof is None:
        return False
    prof.stop()
    os.makedirs(_STATE["dir"], exist_ok=True)
    _STATE["n"] += 1
    path = os.path.join(_STATE["dir"], f"das_tpu_torch_{os.getpid()}_{_STATE['n']}.trace.json")
    prof.export_chrome_trace(path)
    _STATE["prof"], _STATE["dir"], _STATE["last"] = None, None, path
    return True


def last_trace_path() -> Optional[str]:
    """The file the last maybe_stop_trace wrote."""
    return _STATE["last"]
