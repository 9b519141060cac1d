"""Serving-edge query coalescing with adaptively deep execution
pipelining (port of `das_tpu/service/coalesce.py`).

N concurrent single-query RPCs that each paid one host fetch would
serialize into N round trips behind the tenant lock.  This worker batches
them: every cycle it drains whatever is queued, groups it by tenant and
output format, and runs each group through
`DistributedAtomSpace.query_many_dispatch`: every query of the group is
dispatched before one host fetch.  While a batch executes, new arrivals
queue up and form the next batch, so under load the batch size tracks the
concurrency, with no timer (a lone query is picked up at once).

Pipelining: the worker keeps dispatched but unsettled groups in flight
and sizes the window from what it measures, per-settle round-trip and
per-dispatch cost EWMAs, as `ceil(rtt / dispatch_cost)`, clamped between
`DasConfig.pipeline_depth` (the floor, default 2) and
`DasConfig.pipeline_depth_max`.  Depth 1 is strictly serial.  A dispatch
issued while an earlier group is unsettled is speculative: a racing commit
invalidates it through the dispatch-time `delta_version` guard of
`_QueryManyJob`, which answers anew on the committed store.  Settles stay
FIFO.  On the card each group's settle waits on its own CUDA event
(query/fused.py `_Staged`), not on the stream, so settling group k does
not wait for the kernels of group k+1, dispatched after it.  The worker
dispatches and settles on the current stream, the one the store's tensors
were made on.

Adaptive drain: when the window is starved the backlog is spread across
the free slots (`_adaptive_width`), so narrow batches dispatch at once;
when it is nearly full the whole backlog coalesces into one wide batch.

Streaming settle: `_settle_group` consumes `_QueryManyJob.settle_iter()`
and resolves each query's future as its answer lands
(`stats["early_settles"]`).  Failure isolation is per query: one bad
query fails only its own future, and a group-level dispatch or settle
failure degrades to `query()` for exactly the unresolved members.

Backpressure: the submit queue is bounded (`DasConfig.coalesce_queue_max`,
0 = unbounded); past the bound submit() rejects with
`CoalescerSaturatedError`.  Deadlines (`DasConfig.query_deadline_ms`) are
enforced in the queued and grouped states and at the settle fallback
(typed `DasDeadlineError`; an answer already computed is still
delivered).  A per-tenant circuit breaker (fault.CircuitBreaker) turns
repeated retryable settle failures or sustained saturation into degraded
serving: speculation off, window at its floor, groups dispatched
cache-only (hits answer with no device work, misses reject with a
retryable `BreakerOpenError`), and a half-open probe after the cooldown
restores service.  `fault.maybe_fail` marks the submit, worker and
dispatch seams.

State discipline: `stats`, `history` and the breaker are touched only by
the worker thread (RPC threads read them through snapshot(), torn reads
tolerated); `rejected` and `_worker` are written under `_lock`.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Tuple

from das_tpu_torch import fault, obs
from das_tpu_torch.core.exceptions import (
    BreakerOpenError,
    CoalescerSaturatedError,
    DasDeadlineError,
    InjectedFault,
)

#: EWMA smoothing for the rtt/dispatch-cost estimators: recent samples
#: dominate (load shifts fast) but one outlier drain cannot whipsaw the
#: window size
_EWMA_ALPHA = 0.25

#: bound of the per-tenant ring of (rtt_ewma_ms, dispatch_ewma_ms,
#: effective_depth) samples, one per settled group that paid a fetch:
#: it shows the window's history, where coalescer_stats() shows only
#: the current point.
_HISTORY_K = 64

#: who may mutate each attribute after __init__ (daslint DL006): "_lock"
#: = only under `with self._lock:` (RPC threads race to start the worker
#: and count rejections), "worker" = only in WORKER_METHODS, the
#: coalescer's one worker thread (RPC threads read `stats` through
#: snapshot(), torn reads tolerated).  New mutable state declares its
#: owner here.
LOCK_DISCIPLINE = {
    "QueryCoalescer._worker": "_lock",
    "QueryCoalescer.stats": "worker",
    "QueryCoalescer.rejected": "_lock",
}

#: each coalescer's worker thread is named WORKER_THREAD-<the coalescer's
#: id in hex>, so two coalescers' spans stay apart by thread
WORKER_THREAD = "das-coalescer"

#: the methods that run ON the worker thread (_run and its helpers): the
#: confinement domain of "worker" attributes.  The breaker and `history`
#: are driven only from these methods as well.
WORKER_METHODS = {
    "QueryCoalescer": ("_run", "_group_batch", "_dispatch_group",
                       "_settle_group", "_observe", "_effective_depth",
                       "_expire", "_breaker_sync"),
}


class QueryCoalescer:
    def __init__(self, max_batch: int = None, pipeline_depth: int = None,
                 pipeline_depth_max: int = None, queue_max: int = None,
                 deadline_ms: int = None, breaker_threshold: int = None,
                 breaker_cooldown_ms: int = None):
        # defaults come from DasConfig — ONE source of truth for the
        # served path's throughput knobs (per-query cost
        # halves as concurrency doubles, so the ceiling decides the
        # batched regime; the depth window decides how full the device
        # queue stays); a bare QueryCoalescer() therefore tracks the
        # deployment defaults instead of local constants
        if (max_batch is None or pipeline_depth is None
                or pipeline_depth_max is None or queue_max is None
                or deadline_ms is None or breaker_threshold is None
                or breaker_cooldown_ms is None):
            from das_tpu_torch.core.config import DasConfig

            if max_batch is None:
                max_batch = DasConfig.coalesce_max_batch
            if pipeline_depth is None:
                pipeline_depth = DasConfig.pipeline_depth
            if pipeline_depth_max is None:
                pipeline_depth_max = DasConfig.pipeline_depth_max
            if queue_max is None:
                queue_max = DasConfig.coalesce_queue_max
            if deadline_ms is None:
                deadline_ms = DasConfig.query_deadline_ms
            if breaker_threshold is None:
                breaker_threshold = DasConfig.breaker_failure_threshold
            if breaker_cooldown_ms is None:
                breaker_cooldown_ms = DasConfig.breaker_cooldown_ms
        self.max_batch = max_batch
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.pipeline_depth_max = max(self.pipeline_depth,
                                      int(pipeline_depth_max))
        self.queue_max = max(0, int(queue_max))
        #: per-query serving deadline (ms, 0=off): stamped onto the
        #: submit tuple as an absolute monotonic expiry; the worker
        #: expires queued/grouped entries past it (typed
        #: DasDeadlineError) so no future waits forever on a backlog
        self.deadline_ms = max(0, int(deadline_ms))
        #: per-tenant degraded-mode state machine (fault/):
        #: repeated retryable settle failures or sustained saturation
        #: trip it OPEN — speculation off, window at its floor, cache
        #: hits still served, fresh dispatches rejected retryable —
        #: and a half-open probe restores it.  Driven ONLY from worker
        #: methods (WORKER_METHODS), like `stats`.
        self.breaker = fault.CircuitBreaker(
            failure_threshold=int(breaker_threshold),
            cooldown_ms=float(breaker_cooldown_ms),
        )
        # Queue(maxsize=0) is unbounded — the queue itself enforces the
        # backpressure bound race-free across RPC threads
        self._queue: "queue.Queue[Tuple]" = queue.Queue(maxsize=self.queue_max)
        self._worker: threading.Thread = None
        self._lock = threading.Lock()
        #: observability: batches formed, items served, widest batch seen,
        #: the configured ceiling (so operators can tell "never batched
        #: wider than N" from "capped at N"), the configured depth floor
        #: and ceiling, the CURRENT adaptive window size and the EWMAs it
        #: derives from, the in-flight high-water mark, and the
        #: speculation/early-settle counters
        self.stats = {
            "batches": 0, "items": 0, "max_batch": 0,
            "max_batch_limit": self.max_batch,
            "pipeline_depth": self.pipeline_depth,
            "pipeline_depth_max": self.pipeline_depth_max,
            "effective_depth": self.pipeline_depth,
            "rtt_ewma_ms": 0.0,
            "dispatch_ewma_ms": 0.0,
            "inflight_peak": 0,
            "speculative_dispatches": 0,
            "early_settles": 0,
            #: robustness counters: queries expired past
            #: their deadline, fresh dispatches rejected by an open
            #: breaker, and the breaker lifecycle itself
            "deadline_expired": 0,
            "breaker_rejections": 0,
            "breaker_state": fault.CLOSED,
            "breaker_trips": 0,
            "breaker_probes": 0,
            "breaker_recoveries": 0,
        }
        #: backpressure rejections (RPC-thread side, under _lock)
        self.rejected = {"n": 0}
        #: last-K (rtt_ewma_ms, dispatch_ewma_ms, effective_depth)
        #: samples, appended by the worker after each wire-fed settle —
        #: the window-formula history; maxlen bounds it, append
        #: is atomic, readers snapshot via snapshot()
        self.history: deque = deque(maxlen=_HISTORY_K)

    def submit(self, tenant, query, output_format) -> Future:
        fut: Future = Future()
        # trace birth: the mark (trace id + submit time)
        # rides the queue tuple to the worker, which closes it at
        # answer delivery; None (zero cost) when tracing is off
        mark = obs.mark()
        # deadline stamp: an absolute monotonic expiry rides
        # the tuple; None when deadlines are off so the disabled path
        # costs one comparison
        deadline = (
            time.monotonic() + self.deadline_ms / 1e3
            if self.deadline_ms > 0 else None
        )
        try:
            # declared injection seam (fault/): a submit-path
            # failure surfaces on THIS caller's future, typed — never
            # on a neighbor's.  Delivered via _resolve so the trace
            # opened by mark() above closes (serve.answer + latency
            # sample) like every other resolution path.
            fault.maybe_fail("submit_queue")
        except InjectedFault as exc:
            self._resolve(fut, exc, mark)
            return fut
        try:
            self._queue.put_nowait(
                (tenant, query, output_format, fut, mark, deadline)
            )
        except queue.Full:
            # reject-with-error beyond the bound: unbounded acceptance
            # would grow host memory with the open-loop client count;
            # the caller sees the error on its future, same surface as
            # any per-query failure
            with self._lock:
                self.rejected["n"] += 1
            if mark is not None:
                obs.event("serve.reject", trace=mark[0],
                          bound=self.queue_max)
                obs.counter("serve.rejections").inc()
            fut.set_exception(CoalescerSaturatedError(
                f"coalescer submit queue at its bound "
                f"({self.queue_max}); retry later"
            ))
            return fut
        if mark is not None:
            obs.event("serve.submit", trace=mark[0],
                      tenant=getattr(tenant, "name", None))
            obs.counter("serve.submitted").inc()
        self._ensure_worker()
        return fut

    def snapshot(self) -> Dict:
        """One merged observability dict (worker stats + the RPC-side
        rejection counter + the last-K window-formula sample ring) —
        torn reads tolerated, same as stats."""
        out = dict(self.stats)
        out["queue_rejections"] = self.rejected["n"]
        out["window_history"] = list(self.history)
        return out

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                # named, so a trace shows the worker as a track of its own
                # and readers pick its spans by thread
                self._worker = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{WORKER_THREAD}-{id(self):x}",
                )
                self._worker.start()

    def _drain(self, block: bool, limit: int = None) -> List[Tuple]:
        """One batch up to `limit` (None = the configured ceiling):
        blocking waits for the first item (idle coalescer); non-blocking
        returns [] when nothing is queued (pipeline top-up).  Only the
        blocking wait is the `serve.idle` span: the worker has nothing in
        flight or grouped and waits for a submit."""
        limit = self.max_batch if limit is None else limit
        if block:
            with obs.span("serve.idle"):
                batch = [self._queue.get(block=True)]
        else:
            try:
                batch = [self._queue.get_nowait()]
            except queue.Empty:
                return []
        while len(batch) < limit:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    @staticmethod
    def _depth_from(rtt_ms: float, dispatch_ms: float,
                    floor: int, cap: int) -> int:
        """Window size that hides the wire: enough dispatches in flight
        to cover one settle round-trip, `ceil(rtt / dispatch_cost)`,
        clamped to [floor, cap].  No samples yet (either EWMA zero) →
        the floor, i.e. exactly the pre-adaptive behavior."""
        if rtt_ms <= 0.0 or dispatch_ms <= 0.0:
            return floor
        return max(floor, min(cap, math.ceil(rtt_ms / dispatch_ms)))

    def _effective_depth(self) -> int:
        """Current adaptive window size.  An explicit serial coalescer
        (pipeline_depth=1) never adapts upward — depth 1 must stay
        exactly the old serial behavior.  A non-CLOSED breaker forces
        depth 1: degraded mode turns speculation OFF (every speculative
        dispatch is a program a failing tenant would waste) and holds
        the window at its floor until a probe restores service."""
        if self.breaker.state != fault.CLOSED:
            self.stats["effective_depth"] = 1
            return 1
        if self.pipeline_depth <= 1:
            return 1
        depth = self._depth_from(
            self.stats["rtt_ewma_ms"], self.stats["dispatch_ewma_ms"],
            self.pipeline_depth, self.pipeline_depth_max,
        )
        self.stats["effective_depth"] = depth
        return depth

    def _adaptive_width(self, free_slots: int) -> int:
        """Drain ceiling for the next batch: spread the current backlog
        evenly across the free window slots.  A starved window (many
        free slots) gets narrow batches that dispatch immediately; a
        nearly-full window coalesces wide (one settle, maximum in-batch
        dedup).  Empty queue → the full ceiling (the blocking first-item
        wait then takes whatever arrives)."""
        queued = self._queue.qsize()
        if queued <= 0 or free_slots <= 1:
            return self.max_batch
        return max(1, min(self.max_batch, -(-queued // free_slots)))

    def _observe(self, key: str, ms: float) -> None:
        """EWMA update for the rtt / dispatch-cost estimators."""
        prev = self.stats[key]
        self.stats[key] = round(
            ms if prev == 0.0 else (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * ms,
            4,
        )

    def _run(self) -> None:
        # the in-flight window and the grouped-but-undispatched queue
        # live here; everything batch-scoped stays inside the helpers so
        # an idle coalescer (empty window, blocked in queue.get) never
        # pins a multi-GB store alive
        inflight: deque = deque()   # dispatched, awaiting settle (FIFO)
        ready: deque = deque()      # (tenant, fmt, group) not yet dispatched
        rej_seen = 0                # rejections already fed to the breaker
        while True:
            # the worker must never die: every helper resolves its own
            # futures (dispatch/settle/grouping each catch internally and
            # the resolution loop tolerates cancel races), so anything
            # escaping here is unexpected — survive it, keep serving the
            # remaining in-flight entries, and never strand the queue
            # (RPC threads block on these futures with no timeout)
            try:
                # declared injection seam (fault/): anything this
                # iteration raises — injected included — lands in the
                # catch below and the worker keeps serving
                fault.maybe_fail("worker_iteration")
                # sustained saturation feeds the breaker: every submit
                # rejection since the last pass counts as a failure
                # signal (the worker reads the RPC-side counter, never
                # writes it — the single-consumer idiom).  Only while
                # CLOSED: once tripped, the queue drains slowly by
                # design, and a rejection landing mid-probe must not
                # re-open the breaker over the probe's own verdict —
                # the half-open probe is the sole recovery authority.
                rejected_now = self.rejected["n"]
                if self.breaker.state == fault.CLOSED:
                    for _ in range(rejected_now - rej_seen):
                        self.breaker.record_failure()
                if rejected_now != rej_seen:
                    rej_seen = rejected_now
                    self._breaker_sync()
                # fill the window up to the ADAPTIVE depth — ONE dispatch
                # per entry, so a drained batch that splits into several
                # (tenant, format) groups never overshoots the in-flight
                # bound (the extra groups wait in `ready`)
                depth = self._effective_depth()
                while len(inflight) < depth:
                    if not ready:
                        # block for work only when nothing is in flight
                        # or grouped — otherwise an empty queue must fall
                        # through to settle, not wait
                        width = self._adaptive_width(depth - len(inflight))
                        with obs.span("serve.drain", width=width) as sp:
                            batch = self._drain(
                                block=not (inflight or ready),
                                limit=width,
                            )
                            sp.set(queries=len(batch))
                        if not batch:
                            break
                        self._group_batch(batch, ready)
                        batch = None  # don't pin store refs while idle
                        continue
                    speculative = bool(inflight)
                    if speculative:
                        # an earlier group is still unsettled: this
                        # dispatch is speculative — a racing commit
                        # invalidates it via the delta_version guard
                        self.stats["speculative_dispatches"] += 1
                        if obs.enabled():
                            obs.counter("serve.speculative").inc()
                    inflight.append(
                        self._dispatch_group(*ready.popleft(),
                                             speculative=speculative)
                    )
                    self.stats["inflight_peak"] = max(
                        self.stats["inflight_peak"], len(inflight)
                    )
                if inflight:
                    self._settle_group(inflight.popleft())
            except Exception:  # noqa: BLE001 — see comment above
                continue

    def _group_batch(self, batch: List[Tuple], ready: deque) -> None:
        """Split one drained batch into (tenant, format) groups onto the
        ready queue.  A failure here must not strand futures: the RPC
        threads block on them with no timeout."""
        try:
            with obs.span("serve.group", queries=len(batch)) as sp:
                self.stats["batches"] += 1
                self.stats["items"] += len(batch)
                self.stats["max_batch"] = max(
                    self.stats["max_batch"], len(batch)
                )
                # deadline expiry in the QUEUED state: an
                # entry that waited out its deadline in the submit queue
                # resolves typed here and never forms a group
                now = time.monotonic()
                batch = [
                    item for item in batch if not self._expire(item, now)
                ]
                by_tenant: Dict[int, List[Tuple]] = {}
                for item in batch:
                    by_tenant.setdefault(id(item[0]), []).append(item)
                n_groups = 0
                for items in by_tenant.values():
                    tenant = items[0][0]
                    # one format group at a time keeps the job's signature
                    # simple; mixed-format batches are split (rare in
                    # practice)
                    by_fmt: Dict[object, List[Tuple]] = {}
                    for item in items:
                        by_fmt.setdefault(item[2], []).append(item)
                    for fmt, group in by_fmt.items():
                        ready.append((tenant, fmt, group))
                        n_groups += 1
                sp.set(groups=n_groups)
        except Exception as exc:  # noqa: BLE001 — futures must resolve
            for item in batch:
                if not item[3].done() and not item[3].cancelled():
                    item[3].set_exception(exc)

    def _dispatch_group(self, tenant, fmt, group: List[Tuple],
                        speculative: bool = False) -> Tuple:
        """Phase 1 for one (tenant, format) group: plan + async device
        dispatch under the tenant lock.  Returns the in-flight entry;
        job=None means settle must run the serial per-query fallback.
        The host-side cost feeds the dispatch EWMA the window sizes from
        ONLY when the group actually ENQUEUED device programs — the
        symmetric twin of the rtt guard: a sub-ms all-cache-hit or
        failed dispatch read as "the per-slot cost" would drag the
        estimator toward zero and peg ceil(rtt/dispatch) at
        pipeline_depth_max exactly when deeper speculation buys nothing
        (and maximizes the programs a racing commit can invalidate).

        Tracing: the group gets a GROUP id published through
        the recorder's thread-local, so the executor spans recorded
        under this dispatch (exec.dispatch inside query_many_dispatch,
        cache events) link back to the member traces without signature
        changes; the serve.dispatch span carries the window state AT
        dispatch time — effective depth, both EWMAs, the tenant's
        delta_version — the attributes the window-formula decision
        reads off a trace."""
        # deadline expiry in the GROUPED state: entries that waited out
        # their deadline in `ready` resolve typed instead of paying a
        # device dispatch nobody is waiting for
        now = time.monotonic()
        group = [item for item in group if not self._expire(item, now)]
        if not group:
            return (tenant, fmt, group, None, 0, False)
        # degraded-mode gate: a non-closed breaker refuses
        # fresh device dispatches — the group runs CACHE-ONLY (hits
        # still answer with zero device work; misses become typed
        # retryable rejections at settle).  allow() grants exactly one
        # half-open probe per cooldown, which dispatches normally and
        # whose settle verdict decides recovery.
        degraded = not self.breaker.allow()
        self._breaker_sync()
        gid = 0
        sp = obs.NOOP_SPAN
        if obs.enabled():
            gid = obs.new_trace()
            now = time.perf_counter()
            marks = [self._mark_of(item) for item in group]
            # the members' submit -> dispatch waits; a query submitted
            # before tracing was switched on has no mark and no wait
            queue_s, queued = 0.0, 0
            for m in marks:
                if m is not None:
                    wait = now - m[1]
                    queue_s += wait
                    queued += 1
                    obs.histogram("serve.queue_ms").observe(wait * 1e3)
            obs.set_context(
                lane=getattr(tenant, "name", None), group=gid
            )
            sp = obs.span(
                "serve.dispatch", trace=gid,
                queries=len(group), speculative=speculative,
                degraded=degraded,
                effective_depth=self.stats["effective_depth"],
                rtt_ewma_ms=self.stats["rtt_ewma_ms"],
                dispatch_ewma_ms=self.stats["dispatch_ewma_ms"],
                delta_version=getattr(
                    getattr(tenant.das, "db", None), "delta_version", None
                ),
                traces=[m[0] for m in marks if m is not None],
                queue_s=queue_s, queued=queued,
            )
        t0 = time.perf_counter()
        job = None
        try:
            # declared injection seam (fault/): a failed enqueue
            # degrades the whole group to settle's per-query fallbacks —
            # the host seam, NOT inside the dispatch halves
            fault.maybe_fail("dispatch_enqueue")
            with tenant.lock, sp:
                job = tenant.das.query_many_dispatch(
                    [item[1] for item in group], fmt,
                    cache_only=degraded,
                )
        except Exception:  # noqa: BLE001 — settle's fallback isolates
            job = None
        pending = getattr(job, "pending", None)
        if pending is not None and getattr(pending, "jobs", None):
            dispatch_ms = (time.perf_counter() - t0) * 1e3
            self._observe("dispatch_ewma_ms", dispatch_ms)
            if obs.enabled():
                obs.histogram("serve.dispatch_ms").observe(dispatch_ms)
        return (tenant, fmt, group, job, gid, degraded)

    @staticmethod
    def _mark_of(item: Tuple):
        """The obs mark riding a queue tuple — None when tracing was off
        at submit, and tolerant of 4-tuples built by direct callers of
        the group helpers (the test harness idiom)."""
        return item[4] if len(item) > 4 else None

    @staticmethod
    def _deadline_of(item: Tuple):
        """The absolute monotonic expiry riding a queue tuple — None
        when deadlines are off or for short tuples built by direct
        callers of the group helpers."""
        return item[5] if len(item) > 5 else None

    def _expire(self, item: Tuple, now: float = None) -> bool:
        """Expire one entry past its deadline (worker-side):
        resolve its future with a typed DasDeadlineError and count the
        miss.  Returns True when the entry is DEAD (expired now or
        already resolved by an earlier expiry pass) — callers skip dead
        entries instead of dispatching/falling back for them, which is
        what keeps a backlogged worker from burning device time on
        answers nobody is waiting for."""
        deadline = self._deadline_of(item)
        if deadline is None:
            return False
        if (time.monotonic() if now is None else now) < deadline:
            return False
        delivered = self._resolve(
            item[3],
            DasDeadlineError(deadline_ms=self.deadline_ms),
            self._mark_of(item),
        )
        if delivered:
            self.stats["deadline_expired"] += 1
            if obs.enabled():
                mark = self._mark_of(item)
                obs.event("serve.deadline",
                          trace=mark[0] if mark else 0,
                          deadline_ms=self.deadline_ms)
                obs.counter("serve.deadline_misses").inc()
        return True

    def _breaker_sync(self) -> None:
        """Mirror the breaker's lifecycle into `stats` (worker-side) so
        snapshot()/coalescer_stats() surface state + transition counts
        without reaching into the fault layer."""
        snap = self.breaker.snapshot()
        self.stats["breaker_state"] = snap["state"]
        self.stats["breaker_trips"] = snap["trips"]
        self.stats["breaker_probes"] = snap["probes"]
        self.stats["breaker_recoveries"] = snap["recoveries"]

    @staticmethod
    def _resolve(fut: Future, answer, mark=None) -> bool:
        """Deliver one answer; True only when the future was actually
        set — the early-settle counters must not credit deliveries that
        never happened (a client cancelling mid-settle).  A delivered
        answer closes its trace (serve.answer + the submit→answer
        latency histogram the p50/p95/p99 derive from)."""
        if fut.done() or fut.cancelled():
            return False
        try:
            if isinstance(answer, Exception):
                fut.set_exception(answer)
            else:
                fut.set_result(answer)
        except Exception:  # noqa: BLE001 — cancelled/resolved between
            return False  # the check and the set: nothing is owed
        if mark is not None and obs.enabled():
            obs.event("serve.answer", trace=mark[0],
                      error=isinstance(answer, Exception))
            obs.counter("serve.answers").inc()
            obs.histogram("serve.answer_ms").observe(
                (time.perf_counter() - mark[1]) * 1e3
            )
        return True

    def _settle_group(self, entry: Tuple) -> None:
        """Phase 2: STREAM the settle — resolve each query's future as
        its answer lands (settle_iter), so early answers reach their
        clients before the group's later fallbacks run.  Any query the
        iterator never reached (a group-level settle failure) degrades
        to an individual `query()` call surfacing only its OWN error.
        The rtt EWMA the window sizes from is fed ONLY the group's first
        host transfer, timed at the PRODUCER where the fetch happens
        (query/fused.py settle_pending_iter → `job.settle_rtt_ms`) —
        never inferred from yield timing here.  A group with no fetch at
        all (every entry a dispatch-time cache hit, everything declined,
        or a commit race dropping the round to the per-query re-run
        path) reports None and feeds nothing: cache hits, staged
        replays, materialization, and per-query fallbacks are host CPU
        work the single worker thread cannot overlap, and counting any
        of it would mis-size the window — a sub-ms hit read as "the
        wire" collapses it to the floor on the hot cached workload, a
        fallback re-run read as "the wire" pegs it at
        pipeline_depth_max exactly when deeper speculation buys
        nothing.

        The tenant lock is held only AROUND each settle_iter step, never
        across a future resolution: done-callbacks run client code, and
        a blocking callback must not extend the tenant lock (the old
        blocking settle resolved outside the lock too).  A commit CAN
        therefore land between steps — settle_iter's per-yield
        delta_version re-check (api/atomspace.py) is what keeps the
        remainder sound."""
        tenant, fmt, group, job = entry[:4]
        # the group id links this settle to its dispatch span; 0 for
        # 4-entries built by direct callers (the test harness idiom)
        gid = entry[4] if len(entry) > 4 else 0
        # degraded flag: this group was dispatched cache-only
        # under an open breaker — unresolved members reject retryable
        # instead of falling back to per-query device work
        degraded = entry[5] if len(entry) > 5 else False
        sp = obs.NOOP_SPAN
        cpu0 = None
        if obs.enabled():
            obs.set_context(lane=getattr(tenant, "name", None), group=gid)
            sp = obs.span("serve.settle", trace=gid, queries=len(group),
                          degraded=degraded)
            # the worker thread's CPU clock over the span: wall time
            # minus cpu_s is time the worker waited (for the GIL, or
            # blocked in the fetch)
            cpu0 = time.thread_time()
        t_settle0 = time.perf_counter()
        streamed = 0
        delivered_last = False
        settle_broke = False    # the streamed settle died mid-iteration
        retryable_errors = 0    # transport-class per-query failures
        with sp:
            if job is not None:
                it = job.settle_iter()
                while True:
                    try:
                        with tenant.lock:
                            i, answer = next(it)
                    except StopIteration:
                        break
                    except Exception:  # noqa: BLE001 — per-query fallback
                        settle_broke = True
                        break
                    if isinstance(answer, BreakerOpenError):
                        # degraded-mode rejection from the cache-only
                        # job: stamp the retry-after hint only the
                        # breaker knows
                        if answer.retry_after_ms is None:
                            answer.retry_after_ms = (
                                self.breaker.retry_after_ms()
                            )
                        self.stats["breaker_rejections"] += 1
                    elif isinstance(answer, Exception) and (
                        fault.is_retryable(answer)
                    ):
                        retryable_errors += 1
                    delivered_last = self._resolve(
                        group[i][3], answer, self._mark_of(group[i])
                    )
                    if delivered_last:
                        streamed += 1
                rtt = getattr(job, "settle_rtt_ms", None)
                if rtt is not None:
                    self._observe("rtt_ewma_ms", rtt)
                    # the window-formula history: one sample per
                    # wire-fed settle — exactly the settles whose rtt the
                    # adaptive window actually sized from
                    self.history.append((
                        self.stats["rtt_ewma_ms"],
                        self.stats["dispatch_ewma_ms"],
                        self.stats["effective_depth"],
                    ))
                sp.set(streamed=streamed, settle_rtt_ms=rtt)
            fellback = 0
            for item in group:
                # whole-or-partial settle failure: per-RPC isolation,
                # exactly like the uncoalesced path — run the unresolved
                # individually
                fut = item[3]
                if fut.done() or fut.cancelled():
                    continue
                # deadline expiry IN FLIGHT: an entry whose deadline
                # passed while its group was dispatched/settling is
                # abandoned host-side — typed, no fallback query
                if self._expire(item):
                    continue
                if degraded:
                    # degraded mode never runs fresh per-query device
                    # work; unresolved members reject retryable with
                    # the breaker's retry-after hint
                    self.stats["breaker_rejections"] += 1
                    self._resolve(
                        fut,
                        BreakerOpenError(
                            retry_after_ms=self.breaker.retry_after_ms()
                        ),
                        self._mark_of(item),
                    )
                    continue
                try:
                    with tenant.lock:
                        answer = tenant.das.query(item[1], fmt)
                except Exception as exc:  # noqa: BLE001 — per-future
                    answer = exc
                if isinstance(answer, Exception) and (
                    fault.is_retryable(answer)
                ):
                    retryable_errors += 1
                if self._resolve(fut, answer, self._mark_of(item)):
                    fellback += 1
            sp.set(fallbacks=fellback)
            # breaker verdict for this group (worker-side):
            # transport-class failures — a broken streamed settle or
            # retryable per-query errors — count against the tenant;
            # a clean non-degraded group is the success signal that
            # closes a half-open probe and clears the failure streak.
            # Degraded (cache-only) groups are neither: they never
            # touched the device, so they carry no health signal.
            if group and not degraded:
                if settle_broke or retryable_errors:
                    self.breaker.record_failure()
                else:
                    self.breaker.record_success()
                self._breaker_sync()
            if cpu0 is not None:
                sp.set(cpu_s=time.thread_time() - cpu0)
        if obs.enabled():
            obs.histogram("serve.settle_ms").observe(
                (time.perf_counter() - t_settle0) * 1e3
            )
        if streamed:
            # every delivered answer except the group's last reached its
            # client BEFORE the group finished settling — and when
            # anything happened AFTER the last delivery (a fallback
            # resolution, or a trailing yield whose future was already
            # cancelled), even that last delivery preceded group
            # completion
            self.stats["early_settles"] += (
                streamed if (fellback or not delivered_last)
                else streamed - 1
            )
