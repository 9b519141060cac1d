"""The `das` package's hashers (reference das/expression_hasher.py:4-60),
from das_tpu_torch."""

from das_tpu_torch.core.hashing import (  # noqa: F401
    ExpressionHasher,
    StringExpressionHasher,
)
