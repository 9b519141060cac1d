"""The `das` package's Transaction (reference das/transaction.py:1-10),
from das_tpu_torch."""

from das_tpu_torch.api.atomspace import Transaction  # noqa: F401
