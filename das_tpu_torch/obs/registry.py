"""The declared span, counter and histogram names of the trace and metric
layer (port of `das_tpu/obs/registry.py`; the `prof.*` names are the
program ledger's, obs/proflog.py).

Every name passed to `obs.span` / `obs.event`, `obs.counter` or
`obs.histogram` anywhere in `das_tpu_torch/` is a member of one of these
tuples; the metric dicts (obs/metrics.py COUNTERS / HISTOGRAMS) are built
from them, so a typo'd name is a KeyError instead of a lane nobody
watches.  This module imports nothing.
"""

#: every span ("X" complete event) and instant-event name the recorder
#: accepts, `<layer>.<stage>`
SPAN_NAMES = (
    #: instant: one query accepted into the coalescer submit queue
    #: (service/coalesce.py submit); the trace id is born here
    "serve.submit",
    #: instant: backpressure rejection at the queue bound
    "serve.reject",
    #: span: one worker drain; attrs: width limit, queries drained
    "serve.drain",
    #: span: a drained batch split into (tenant, format) groups
    "serve.group",
    #: span: per-group query planning (api/atomspace.py _QueryManyJob)
    "serve.plan",
    #: span: per-group enqueue under the tenant lock; attrs: group width,
    #: speculative flag, effective depth, dispatch EWMA
    "serve.dispatch",
    #: span: per-group streamed settle; attrs: streamed and fallback
    #: counts, settle rtt
    "serve.settle",
    #: instant: one query's future resolved; closes the trace id opened
    #: at serve.submit
    "serve.answer",
    #: span: one job's kernel enqueue (query/fused.py _ExecJob and
    #: _TreeExecJob dispatch halves); attrs: route, round, planner rows
    "exec.dispatch",
    #: span: one settle round's host fetch (query/fused.py
    #: settle_pending_iter, run_tree_job)
    "exec.settle_fetch",
    #: span: binding table -> frozen assignments (query/compiler.py)
    "exec.materialize",
    #: instants: delta-versioned result and tree cache traffic
    #: (query/fused.py ResultCache)
    "cache.hit",
    "cache.miss",
    "cache.invalidate",
    #: instants: delta_version bumps (storage/delta.py): incremental
    #: commit vs full rebuild
    "commit.delta",
    "commit.rebuild",
    #: instant: planner estimated vs actual rows at job settle (planner/)
    "planner.observe",
    #: instant: one query expired past its serving deadline
    #: (service/coalesce.py, DasConfig.query_deadline_ms)
    "serve.deadline",
    #: instant: a tenant circuit-breaker transition; attrs: frm/to
    #: (fault CircuitBreaker: closed/open/half_open)
    "serve.breaker",
    #: instant: one injected fault fired at a FAULT_SITES seam
    #: (fault maybe_fail)
    "fault.inject",
    #: span: one program's first call recorded by the program ledger
    #: (obs/proflog.py), in a "compile" lane of its own; attrs: site,
    #: digest, persistent_cache_hit
    "prof.compile",
    #: span: one atomic generational snapshot write (storage/durable.py
    #: write_snapshot); attrs: generation, delta_version
    "dur.snapshot",
    #: span: one restore: newest valid generation + WAL replay + warm
    #: bundle (storage/durable.py restore)
    "dur.restore",
    #: instant: one write-ahead log record appended and fsynced
    #: (storage/durable.py DeltaLog.append); attrs: version, kind, bytes
    "dur.wal_append",
    #: instant: a torn WAL tail truncated at the last valid frame
    #: (storage/durable.py _truncate_wal)
    "dur.wal_truncate",
)

#: monotone counters (obs/metrics.py COUNTERS is built from this)
COUNTER_NAMES = (
    "serve.submitted",
    "serve.answers",
    "serve.rejections",
    "serve.speculative",
    "cache.hits",
    "cache.misses",
    "cache.invalidations",
    "commit.deltas",
    "commit.rebuilds",
    "exec.dispatches",
    "exec.fetches",
    #: queries expired past their serving deadline (service/coalesce.py)
    "serve.deadline_misses",
    #: circuit-breaker trips CLOSED->OPEN and recoveries HALF_OPEN->CLOSED
    "serve.breaker_trips",
    "serve.breaker_recoveries",
    #: injected faults fired and retry attempts taken (fault maybe_fail,
    #: RetryPolicy)
    "fault.injected",
    "fault.retries",
    #: programs first called, as recorded by the program ledger
    "prof.compiles",
    #: snapshot generations written, WAL records appended and fsynced,
    #: WAL records replayed by restore() (storage/durable.py)
    "dur.snapshots",
    "dur.wal_records",
    "dur.recovery_replayed",
)

#: fixed log-bucket latency histograms (obs/metrics.py HISTOGRAMS): p50,
#: p95 and p99 without keeping samples; all record wall milliseconds
HISTOGRAM_NAMES = (
    #: submit -> group dispatch (queue, drain and grouping wait)
    "serve.queue_ms",
    #: per-group host-side dispatch cost (the window formula's divisor)
    "serve.dispatch_ms",
    #: per-group streamed settle wall time
    "serve.settle_ms",
    #: submit -> answer delivery
    "serve.answer_ms",
    #: one settle round's host fetch
    "exec.settle_fetch_ms",
    #: wall time of one program's first call (obs/proflog.py)
    "prof.compile_ms",
    #: wall time of one restore (storage/durable.py restore)
    "dur.restore_ms",
)
