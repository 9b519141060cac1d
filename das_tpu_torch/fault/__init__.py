"""Seeded fault injection and the recovery machinery it exercises (port of
`das_tpu/fault/__init__.py`).

  * **Injection.** `maybe_fail(site)` at each declared `FAULT_SITES` seam,
    driven by a seeded schedule parsed from a spec string.  It raises a
    typed `InjectedFault` (or sleeps, in latency mode), never corrupts
    silently.  Off by default: one module-global read and a None check.
  * **RetryPolicy.** One retry and backoff implementation (max attempts,
    exponential backoff, deterministic jitter, per-class retryability)
    around settle fetches (query/fused.py), commit applies
    (storage/delta.py) and durable reads (storage/durable.py).
  * **CircuitBreaker.** The per-tenant degraded-mode state machine the
    coalescer (service/coalesce.py) drives.

The schedule is armed only by `configure(spec)`; no environment variable
is read.
Injection stays out of `das_tpu_torch/kernels/` and out of the dispatch
halves, which must stay exactly as they are without a plan.

Spec string: semicolon-separated `key=value` pairs —

    seed=7;sites=settle_fetch,commit_apply;rate=0.25;max=4
    seed=1;sites=*;every=3;max=2;mode=latency;latency_ms=5

  seed        schedule seed (default 0)
  sites       comma list of FAULT_SITES members, or `*` (required)
  rate        per-call failure probability, decided by a crc32 hash of
              (seed, site, call index): the same spec fires on the same
              calls in this package and in das_tpu
  every       fire on every Nth call of a site (overrides rate)
  max         per-site cap on injected failures (default 4)
  mode        error (raise InjectedFault, default) | latency (sleep)
  latency_ms  sleep of latency mode (default 1.0)

Unlike das_tpu, `is_retryable` does not retry a runtime error of the
device: a CUDA launch error is sticky (it poisons the context), so a
retry cannot succeed.  Retryable are `InjectedFault` (unless terminal)
and `ConnectionError`.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

from das_tpu_torch.core.exceptions import DasError, InjectedFault

#: the closed set of host-side seams `maybe_fail` may guard; each names a
#: recovery path the chaos tests exercise.  None lies in
#: das_tpu_torch/kernels/ or in a dispatch half.
FAULT_SITES = (
    #: coalescer submit (service/coalesce.py submit): the caller sees the
    #: typed error on its own future
    "submit_queue",
    #: top of the coalescer worker loop (service/coalesce.py _run): the
    #: worker survives anything its iteration raises
    "worker_iteration",
    #: the host-side group enqueue (service/coalesce.py _dispatch_group,
    #: outside the dispatch halves): the group degrades to per-query
    #: settle fallbacks
    "dispatch_enqueue",
    #: a settle round's host fetch (query/fused.py settle_pending_iter,
    #: _run_batch_group): RetryPolicy's beat
    "settle_fetch",
    #: result-cache insert (query/fused.py ResultCache.put): a failure
    #: leaves the result uncached, the query does not fail
    "cache_insert",
    #: incremental-commit apply, after staging and before the swap
    #: (storage/delta.py _apply_delta): stage-then-swap makes it atomic
    "commit_apply",
    #: -- durability seams (storage/durable.py): a crash at any of these
    #: restores to the same answers --
    #: start of one atomic section write, before any byte lands
    #: (durable.atomic_write)
    "snapshot_write",
    #: between a section's fsync and its rename, and before the
    #: generation directory's rename (durable.atomic_write /
    #: _publish_generation)
    "snapshot_rename",
    #: start of one WAL record append, before framing (DeltaLog.append):
    #: the commit fails before the swap
    "wal_append",
    #: after the WAL record's write and before its fsync; a retried
    #: commit's twin record is skipped by delta_version at replay
    "wal_fsync",
    #: restore-path section and WAL reads (durable._verified_bytes /
    #: read_wal): a transient read failure retries; corruption stays a
    #: typed SnapshotCorruptError
    "restore_read",
)

#: per-site injected-failure tally (plain += under the GIL, torn reads
#: tolerated): callers read it to check that a schedule fired
INJECT_COUNTS: Dict[str, int] = {site: 0 for site in FAULT_SITES}


class FaultSpecError(DasError):
    """Malformed fault spec string."""


def _hash_unit(seed: int, site: str, n: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, site, call index) —
    the schedule is a pure function of the spec, never of RNG state."""
    h = zlib.crc32(f"{seed}:{site}:{n}".encode()) & 0xFFFFFFFF
    return h / 2.0**32


class _FaultPlan:
    """One parsed, armed injection schedule.  All counters live behind
    one lock — injection is a cold path by construction (the disabled
    fast path never reaches here)."""

    __slots__ = (
        "spec", "seed", "sites", "rate", "every", "max_failures",
        "mode", "latency_ms", "_calls", "_fails", "_lock",
    )

    def __init__(self, spec: str, seed: int, sites: Tuple[str, ...],
                 rate: float, every: int, max_failures: int,
                 mode: str, latency_ms: float):
        self.spec = spec
        self.seed = seed
        self.sites = frozenset(sites)
        self.rate = rate
        self.every = every
        self.max_failures = max_failures
        self.mode = mode
        self.latency_ms = latency_ms
        self._calls: Dict[str, int] = {}
        self._fails: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _fires(self, site: str, n: int) -> bool:
        if self.every > 0:
            return (n + 1) % self.every == 0
        return _hash_unit(self.seed, site, n) < self.rate

    def check(self, site: str) -> None:
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
            if site not in self.sites:
                return
            if self._fails.get(site, 0) >= self.max_failures:
                return
            if not self._fires(site, n):
                return
            self._fails[site] = self._fails.get(site, 0) + 1
        INJECT_COUNTS[site] += 1
        from das_tpu_torch import obs

        if obs.enabled():
            obs.event("fault.inject", site=site, call=n, mode=self.mode)
            obs.counter("fault.injected").inc()
        if self.mode == "latency":
            time.sleep(self.latency_ms / 1e3)
            return
        raise InjectedFault(site, n)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "spec": self.spec,
                "calls": dict(self._calls),
                "failures": dict(self._fails),
            }


def parse_spec(spec: Optional[str]) -> Optional[_FaultPlan]:
    """Parse a fault spec string; None/empty means off.
    Unknown keys and undeclared site names are hard errors — a typo'd
    chaos schedule that silently injects nothing is worse than none."""
    if not spec:
        return None
    fields = {
        "seed": "0", "sites": "", "rate": "0.5", "every": "0",
        "max": "4", "mode": "error", "latency_ms": "1.0",
    }
    for pair in spec.split(";"):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise FaultSpecError(f"malformed fault spec pair {pair!r}")
        key, value = pair.split("=", 1)
        key = key.strip()
        if key not in fields:
            raise FaultSpecError(f"unknown fault spec key {key!r}")
        fields[key] = value.strip()
    raw_sites = fields["sites"]
    if not raw_sites:
        raise FaultSpecError("a fault spec needs sites=<name,...> or sites=*")
    if raw_sites == "*":
        sites = FAULT_SITES
    else:
        sites = tuple(s.strip() for s in raw_sites.split(",") if s.strip())
        unknown = [s for s in sites if s not in FAULT_SITES]
        if unknown:
            raise FaultSpecError(
                f"undeclared fault site(s) {unknown} — FAULT_SITES "
                f"declares {list(FAULT_SITES)}"
            )
    mode = fields["mode"]
    if mode not in ("error", "latency"):
        raise FaultSpecError(f"unknown fault spec mode {mode!r}")
    return _FaultPlan(
        spec=spec,
        seed=int(fields["seed"]),
        sites=sites,
        rate=float(fields["rate"]),
        every=int(fields["every"]),
        max_failures=int(fields["max"]),
        mode=mode,
        latency_ms=float(fields["latency_ms"]),
    )


#: the armed schedule; None is the disabled fast path: `maybe_fail` on
#: the serve path then costs one global read + a None check, allocating
#: nothing
_PLAN: Optional[_FaultPlan] = None


def configure(spec: Optional[str]) -> None:
    """Arm (or with None/"" disarm) an injection schedule: the only way
    a plan is armed."""
    global _PLAN
    _PLAN = parse_spec(spec)


def enabled() -> bool:
    return _PLAN is not None


def plan() -> Optional[_FaultPlan]:
    """The armed schedule (None when off) — tests read its snapshot."""
    return _PLAN


def maybe_fail(site: str) -> None:
    """The injection seam: no-op unless a schedule is armed AND decides
    this call fires.  `site` is a FAULT_SITES member."""
    armed = _PLAN
    if armed is None:
        return
    armed.check(site)


def reset_counts() -> None:
    """Zero INJECT_COUNTS."""
    for site in INJECT_COUNTS:
        INJECT_COUNTS[site] = 0


# -- retry / backoff ---------------------------------------------------------


def is_retryable(exc: BaseException) -> bool:
    """Per-class retryability shared by every recovery site: injected
    faults (unless marked terminal) and connection errors.  A device
    runtime error is not retryable (see the module docstring), nor are
    semantic errors (bad queries, capacity ceilings, deadline expiry),
    each of which has its own recovery path."""
    if isinstance(exc, InjectedFault):
        return exc.retryable
    return isinstance(exc, ConnectionError)


class RetryPolicy:
    """Bounded retry with exponential backoff and DETERMINISTIC jitter.

    One shared implementation for every transport-class recovery site
    (the settle fetch, the commit apply) — replacing the hard-coded
    retry-once idiom.  The jitter derives from (seed, attempt), never
    from RNG state, so a chaos run's timing is a pure function of its
    spec and the determinism test can pin the exact backoff sequence.
    """

    __slots__ = ("max_attempts", "base_ms", "multiplier", "max_backoff_ms",
                 "jitter_frac", "seed", "classify")

    def __init__(self, max_attempts: int = 3, base_ms: float = 1.0,
                 multiplier: float = 2.0, max_backoff_ms: float = 50.0,
                 jitter_frac: float = 0.25, seed: int = 0,
                 classify: Optional[Callable[[BaseException], bool]] = None):
        self.max_attempts = max(1, int(max_attempts))
        self.base_ms = float(base_ms)
        self.multiplier = float(multiplier)
        self.max_backoff_ms = float(max_backoff_ms)
        self.jitter_frac = float(jitter_frac)
        self.seed = int(seed)
        self.classify = classify or is_retryable

    def backoff_ms(self, attempt: int) -> float:
        """Delay before retry `attempt` (1-based): exponential from
        base_ms, capped, with deterministic jitter in
        [0, jitter_frac] of the raw delay."""
        raw = min(
            self.base_ms * self.multiplier ** (attempt - 1),
            self.max_backoff_ms,
        )
        return raw * (1.0 + self.jitter_frac
                      * _hash_unit(self.seed, "backoff", attempt))

    def run(self, fn: Callable, on_retry: Optional[Callable] = None):
        """Call `fn()` up to max_attempts times.  Retries only
        classify()-retryable failures, sleeping backoff_ms between
        attempts; the final failure re-raises typed and untouched.
        `on_retry(attempt, exc)` (optional) runs before each retry —
        call sites keep their own per-attempt accounting there (e.g.
        the FETCH_COUNTS tally stays at the fetch site)."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 — classified below
                attempt += 1
                if attempt >= self.max_attempts or not self.classify(exc):
                    raise
                from das_tpu_torch import obs

                if obs.enabled():
                    obs.counter("fault.retries").inc()
                if on_retry is not None:
                    on_retry(attempt, exc)
                delay = self.backoff_ms(attempt)
                if delay > 0:
                    time.sleep(delay / 1e3)


def fetch_retry() -> RetryPolicy:
    """The settle-fetch and durable-read policy: 3 attempts,
    millisecond-scale backoff; a transient failure costs one beat, a real
    outage surfaces typed after two retries."""
    return RetryPolicy(max_attempts=3, base_ms=1.0, max_backoff_ms=50.0)


def commit_retry() -> RetryPolicy:
    """The commit-apply policy: stage-then-swap (storage/delta.py) makes
    a failed apply side-effect-free, so a transient failure retries the
    whole staged commit safely."""
    return RetryPolicy(max_attempts=3, base_ms=1.0, max_backoff_ms=50.0)


# -- circuit breaker ---------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-tenant degraded-mode state machine (driven by the coalescer
    worker thread — single-threaded by construction, service/coalesce.py
    LOCK_DISCIPLINE).

    CLOSED --(threshold consecutive retryable failures)--> OPEN
    OPEN   --(cooldown elapsed, one probe granted)-------> HALF_OPEN
    HALF_OPEN --(probe succeeds)--> CLOSED   (a recovery)
    HALF_OPEN --(probe fails)----> OPEN      (cooldown restarts)

    While OPEN the coalescer serves cache hits and rejects fresh
    dispatches retryable (`BreakerOpenError` + retry-after hint);
    `failure_threshold <= 0` disables the breaker entirely (allow()
    always True, nothing ever trips)."""

    __slots__ = ("failure_threshold", "cooldown_ms", "clock", "state",
                 "consecutive_failures", "opened_at", "trips", "probes",
                 "recoveries")

    def __init__(self, failure_threshold: int = 8,
                 cooldown_ms: float = 250.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_ms = float(cooldown_ms)
        self.clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.trips = 0
        self.probes = 0
        self.recoveries = 0

    def _transition(self, to: str) -> None:
        frm, self.state = self.state, to
        from das_tpu_torch import obs

        if obs.enabled():
            obs.event("serve.breaker", frm=frm, to=to)

    def allow(self) -> bool:
        """True when a fresh dispatch may proceed.  OPEN past the
        cooldown grants exactly ONE half-open probe; further calls stay
        rejected until that probe's verdict lands."""
        if self.failure_threshold <= 0 or self.state == CLOSED:
            return True
        if self.state == OPEN:
            if (self.clock() - self.opened_at) * 1e3 >= self.cooldown_ms:
                self._transition(HALF_OPEN)
                self.probes += 1
                return True
            return False
        return False  # HALF_OPEN: the granted probe is still in flight

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self._transition(CLOSED)
            self.recoveries += 1
            from das_tpu_torch import obs

            if obs.enabled():
                obs.counter("serve.breaker_recoveries").inc()
        self.consecutive_failures = 0

    def record_failure(self) -> None:
        if self.failure_threshold <= 0:
            return
        if self.state == HALF_OPEN:
            # the probe failed: re-open, restart the cooldown
            self._transition(OPEN)
            self.opened_at = self.clock()
            return
        self.consecutive_failures += 1
        if self.state == CLOSED and (
            self.consecutive_failures >= self.failure_threshold
        ):
            self._transition(OPEN)
            self.opened_at = self.clock()
            self.trips += 1
            from das_tpu_torch import obs

            if obs.enabled():
                obs.counter("serve.breaker_trips").inc()

    def retry_after_ms(self) -> float:
        """Hint for rejected callers: remaining cooldown (OPEN), or one
        full cooldown (HALF_OPEN/CLOSED edge races)."""
        if self.state == OPEN:
            elapsed = (self.clock() - self.opened_at) * 1e3
            return max(0.0, self.cooldown_ms - elapsed)
        return self.cooldown_ms

    def snapshot(self) -> Dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "trips": self.trips,
            "probes": self.probes,
            "recoveries": self.recoveries,
        }
