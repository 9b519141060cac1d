"""The `das` package's Expression (reference das/expression.py:6-56), from
das_tpu_torch."""

from das_tpu_torch.core.expression import Expression  # noqa: F401
