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
