"""Framework exceptions (parity with the reference das/exceptions.py:3-22)."""


class DasError(Exception):
    pass


class MettaLexerError(DasError):
    pass


class MettaSyntaxError(DasError):
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
