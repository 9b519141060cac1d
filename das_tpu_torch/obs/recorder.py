"""Low-overhead structured trace recorder (port of
`das_tpu/obs/recorder.py`).

One process-wide `TraceRecorder` holds a bounded ring of span and instant
events.  A trace id is born at coalescer submit (`new_trace`), rides the
submit-queue tuple to the worker, and every deeper layer (drain, group,
plan, dispatch, settle fetch, materialize or cache hit, answer) attaches
that id or the group id the worker publishes through a thread-local
(`set_context`), so a Chrome-trace view lines a query's answer up with the
dispatch and the settle fetch that produced it.

Off by default, and switched only by `obs.configure(enabled=, capacity=)`;
no environment variable is read.  Off, `span()` returns one shared no-op
context manager and `event()` returns before touching its arguments: no
span objects, no ring appends, no timestamps.  Timing is `time.perf_counter()` only: the
recorder never synchronizes the card.  Past the ring bound (default 65,536
events) the oldest events drop.

Every post-__init__ attribute mutation happens under `_lock`; the hot path
only appends to the maxlen deque, which is atomic under the GIL.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

#: ring bound when none is configured
DEFAULT_RING = 65536

#: who may mutate each TraceRecorder attribute after __init__ (daslint
#: DL006): every one only under `with self._lock:` (configure / reset /
#: new_trace run on any thread; the ring append in `record` is a method
#: call on the deque, atomic under the GIL)
LOCK_DISCIPLINE = {
    "TraceRecorder.enabled": "_lock",
    "TraceRecorder.capacity": "_lock",
    "TraceRecorder._ring": "_lock",
    "TraceRecorder._next": "_lock",
    "TraceRecorder._t_origin": "_lock",
}


class _NoopSpan:
    """THE disabled-path span: one shared instance, no state, no
    timestamps.  `span()` hands this back when tracing is off, so the
    disabled path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False

    def set(self, **_attrs):
        """No-op attribute update (mirrors _Span.set)."""


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: created with its start timestamp, records itself
    on __exit__.  No post-construction mutation of recorder state —
    the single ring append happens at exit."""

    __slots__ = ("_rec", "name", "trace", "attrs", "t0")

    def __init__(self, rec: "TraceRecorder", name: str, trace: int, attrs):
        self._rec = rec
        self.name = name
        self.trace = trace
        self.attrs = attrs
        self.t0 = time.perf_counter()

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. the drained
        width, known only after the blocking get returns)."""
        self.attrs.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self._rec.record(
            self.name, "X", self.t0,
            time.perf_counter() - self.t0, self.trace, self.attrs,
        )
        return False


class TraceRecorder:
    """Bounded ring of (name, phase, t0, dur, trace, group, lane,
    thread, attrs) event tuples plus the trace-id source and the
    worker-published thread-local context."""

    def __init__(self, enabled: Optional[bool] = None,
                 capacity: Optional[int] = None):
        self.enabled = bool(enabled)
        self.capacity = DEFAULT_RING if capacity is None else max(16, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._next = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        #: perf_counter origin: exported timestamps are relative to
        #: recorder construction/reset so traces start near t=0
        self._t_origin = time.perf_counter()

    # -- configuration ----------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if capacity is not None:
                self.capacity = max(16, int(capacity))
                self._ring = deque(self._ring, maxlen=self.capacity)

    def reset(self) -> None:
        with self._lock:
            self._ring = deque(maxlen=self.capacity)
            self._next = 0
            # re-base so a post-reset trace starts near t=0 (the
            # "relative to construction/reset" contract below); spans
            # already open across a reset land at negative ts — reset
            # is a window boundary, not a mid-flight operation
            self._t_origin = time.perf_counter()

    # -- trace ids + worker context --------------------------------------

    def new_trace(self) -> int:
        """A fresh trace id (monotone, process-local); 0 when disabled —
        callers thread 0 around for free and nothing records."""
        if not self.enabled:
            return 0
        with self._lock:
            self._next += 1
            return self._next

    def set_context(self, lane: Optional[str] = None,
                    group: int = 0) -> None:
        """Publish the worker's current (tenant lane, group id): deeper
        spans recorded on this THREAD (executor dispatch/settle halves,
        cache events) inherit them without signature changes.  Lane maps
        to a Perfetto track; group links a device span back to the
        submit traces it served."""
        self._tls.lane = lane
        self._tls.group = group

    def context(self) -> Tuple[Optional[str], int]:
        tls = self._tls
        return getattr(tls, "lane", None), getattr(tls, "group", 0)

    # -- recording --------------------------------------------------------

    def record(self, name: str, phase: str, t0: float, dur: float,
               trace: int, attrs, lane: Optional[str] = None) -> None:
        """`lane` overrides the thread-local context lane for an event
        that belongs on a track of its own, whichever thread made it."""
        if not self.enabled:
            return
        ctx_lane, group = self.context()
        th = threading.current_thread()
        self._ring.append((
            name, phase, t0 - self._t_origin, dur, trace, group,
            lane if lane is not None else ctx_lane, th.name, attrs,
        ))

    def span(self, name: str, trace: int = 0, **attrs):
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, trace, attrs)

    def event(self, name: str, trace: int = 0, **attrs) -> None:
        if not self.enabled:
            return
        self.record(name, "i", time.perf_counter(), 0.0, trace, attrs)

    # -- readout ----------------------------------------------------------

    def events(self) -> List[Tuple]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)
