"""das_tpu_torch.obs — per-query tracing and typed metrics (port of
`das_tpu/obs/`).

A trace id born at coalescer submit threads through drain, group, plan,
dispatch, settle fetch, materialize or cache hit, and answer delivery;
each stage records a host-monotonic span into a bounded ring
(obs/recorder.py), while obs/metrics.py keeps counters and log-bucket
latency histograms.  obs/export.py renders the ring as Chrome trace JSON
and the metrics as Prometheus text (service/server.py `metrics_text`).
obs/torchprof.py adds `torch.profiler` scopes and traces, obs/proflog.py
the program ledger (its own switch, `proflog.configure(enabled=)`).

Off by default.  Only `configure(enabled=, capacity=, annotations=)`
switches it; no environment variable is read.  Off, `span()` returns one shared no-op
context, `event()` and `mark()` return at once and `new_trace()` returns 0.
Names are a closed set (obs/registry.py).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from das_tpu_torch.obs import metrics as metrics  # noqa: F401 — public surface
from das_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace,
    dump_chrome_trace,
    prometheus_text,
)
from das_tpu_torch.obs.metrics import (  # noqa: F401
    counter,
    histogram,
    reset_metrics,
)
from das_tpu_torch.obs.recorder import NOOP_SPAN, TraceRecorder  # noqa: F401
from das_tpu_torch.obs.registry import (  # noqa: F401
    COUNTER_NAMES,
    HISTOGRAM_NAMES,
    SPAN_NAMES,
)
from das_tpu_torch.obs import torchprof as torchprof  # noqa: E402
from das_tpu_torch.obs.torchprof import (  # noqa: F401
    annotation,
    maybe_start_trace,
    maybe_stop_trace,
)

#: the process recorder, off until configured
REC = TraceRecorder()


def enabled() -> bool:
    """Hot-path guard: call sites that would pack attribute dicts check
    this first, so the disabled path costs one attribute read."""
    return REC.enabled


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None,
              annotations: Optional[bool] = None) -> None:
    """Switch the recorder (`enabled`, ring `capacity`) and the
    torch.profiler scopes (`annotations`, obs/torchprof.py); process-wide."""
    REC.configure(enabled=enabled, capacity=capacity)
    torchprof.configure(annotations=annotations)


def reset() -> None:
    """Drop the ring and zero the metric layer."""
    REC.reset()
    reset_metrics()


def span(name: str, trace: int = 0, **attrs):
    """Context manager recording one complete span; the shared no-op when
    tracing is off.  `name` is an obs/registry.py member."""
    return REC.span(name, trace, **attrs)


def event(name: str, trace: int = 0, **attrs) -> None:
    """One instant event; a no-op when tracing is off."""
    REC.event(name, trace, **attrs)


def new_trace() -> int:
    return REC.new_trace()


def set_context(lane: Optional[str] = None, group: int = 0) -> None:
    REC.set_context(lane, group)


def mark() -> Optional[Tuple[int, float]]:
    """(fresh trace id, perf_counter now) of one traced unit of work, or
    None when tracing is off, so carrying a mark through a queue costs
    nothing on the disabled path.  The coalescer attaches one per
    submitted query; answer delivery closes it (serve.answer and the
    serve.answer_ms histogram)."""
    if not REC.enabled:
        return None
    return REC.new_trace(), time.perf_counter()


def events():
    return REC.events()


from das_tpu_torch.obs import proflog as proflog  # noqa: F401, E402
