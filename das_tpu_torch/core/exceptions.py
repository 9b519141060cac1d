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
