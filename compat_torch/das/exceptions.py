"""The `das` package's exceptions (reference das/exceptions.py:3-22), from
das_tpu_torch."""

from das_tpu_torch.core.exceptions import (  # noqa: F401
    AtomeseLexerError,
    AtomeseSyntaxError,
    MettaLexerError,
    MettaSyntaxError,
    UndefinedSymbolError,
)
