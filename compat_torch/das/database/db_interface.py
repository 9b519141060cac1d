"""The `das` package's DBInterface and its constants (reference
das/database/db_interface.py:4-71), from das_tpu_torch."""

from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES, WILDCARD  # noqa: F401
from das_tpu_torch.storage.interface import DBInterface  # noqa: F401
