"""Abstract query surface the pattern matcher programs against.

Method-for-method parity with the reference `DBInterface`
(reference das/database/db_interface.py:7-71); every backend in
das_tpu_torch/storage implements this.  `get_matched_links` and
`get_matched_type_template` return lists of ``(link_handle, (targets...))``
pairs except for the fully-grounded fast path which returns ``[handle]``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Tuple

from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES, WILDCARD  # re-export

__all__ = ["DBInterface", "WILDCARD", "UNORDERED_LINK_TYPES"]


class DBInterface(ABC):
    def __repr__(self):
        return "<DBInterface>"

    @abstractmethod
    def node_exists(self, node_type: str, node_name: str) -> bool: ...

    @abstractmethod
    def link_exists(self, link_type: str, targets: List[str]) -> bool: ...

    @abstractmethod
    def get_node_handle(self, node_type: str, node_name: str) -> str: ...

    @abstractmethod
    def get_link_handle(self, link_type: str, target_handles: List[str]) -> str: ...

    @abstractmethod
    def get_link_targets(self, handle: str) -> List[str]: ...

    @abstractmethod
    def is_ordered(self, handle: str) -> bool: ...

    @abstractmethod
    def get_matched_links(self, link_type: str, target_handles: List[str]): ...

    @abstractmethod
    def get_all_nodes(self, node_type: str, names: bool = False) -> List[str]: ...

    @abstractmethod
    def get_matched_type_template(self, template: List[Any]) -> List[str]: ...

    @abstractmethod
    def get_matched_type(self, link_named_type: str): ...

    @abstractmethod
    def get_node_name(self, node_handle: str) -> str: ...

    @abstractmethod
    def get_matched_node_name(self, node_type: str, substring: str) -> str: ...

    # optional surface ----------------------------------------------------

    def get_atom_as_dict(self, handle: str, arity: int = -1):
        pass

    def get_atom_as_deep_representation(self, handle: str, arity: int = -1):
        pass

    def count_atoms(self) -> Tuple[int, int]:
        pass

    def prefetch(self) -> None:
        pass
