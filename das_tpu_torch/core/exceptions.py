"""Framework exceptions (parity with the reference das/exceptions.py:3-22)."""


class DasError(Exception):
    pass


class MettaLexerError(DasError):
    pass


class MettaSyntaxError(DasError):
    pass


class AtomeseLexerError(DasError):
    pass


class AtomeseSyntaxError(DasError):
    pass


class UndefinedSymbolError(DasError):
    def __init__(self, symbols):
        self.symbols = symbols
        super().__init__(f"Undefined symbols: {symbols}")


class InvalidHandleError(DasError):
    pass


class CapacityOverflowError(DasError):
    """A fixed-capacity device buffer overflowed; the caller retries with a
    larger capacity or falls back to the host algebra."""


class CoalescerSaturatedError(DasError):
    """The serving coalescer's submit queue is at its bound
    (DasConfig.coalesce_queue_max, service/coalesce.py): the request was
    rejected instead of growing host memory without limit; retry later."""


class InjectedFault(DasError):
    """A deterministic injected failure (fault.maybe_fail) at a declared
    FAULT_SITES seam: typed so that a chaos run tells injection from a
    real fault, retryable (unless `retryable=False`) so that it exercises
    the recovery a transient failure would."""

    def __init__(self, site: str, call: int, retryable: bool = True):
        self.site = site
        self.call = call
        self.retryable = retryable
        super().__init__(f"injected fault at site '{site}' (call {call})")


class DasDeadlineError(DasError):
    """A query passed its deadline (DasConfig.query_deadline_ms): expired
    by the coalescer worker while queued or grouped, abandoned at settle,
    or timed out at the bounded RPC wait (service/server.py).  Retryable:
    the answer was not delivered in time."""

    def __init__(self, msg: str = "query deadline exceeded",
                 deadline_ms: float = 0.0):
        self.deadline_ms = deadline_ms
        super().__init__(msg)


class BreakerOpenError(DasError):
    """A batch dispatched in degraded mode (`query_many_dispatch(...,
    cache_only=True)`): cache hits are answered, but this query needed a
    fresh device dispatch and was rejected, retryable.  `retry_after_ms`
    hints when service may resume."""

    def __init__(self, msg: str = "circuit breaker open; retry later",
                 retry_after_ms: float = None):
        self.retry_after_ms = retry_after_ms
        super().__init__(msg)


class SnapshotCorruptError(DasError):
    """A persisted snapshot generation or its write-ahead log failed
    verification (storage/durable.py): a section's CRC-32 does not match
    its manifest digest, the manifest is torn or absent, a WAL frame in
    the middle of the file is corrupt, or WAL replay broke the
    delta_version continuity check.  Restore never serves unverified
    bytes: it falls back to the newest valid prior generation, and raises
    this only when none is left."""
