"""Parsed-expression record.

One `Expression` carries a fully hashed MeTTa/Atomese expression on its way
from a parser into the columnar store.  Field semantics match the reference
record (reference das/expression.py:6-56): `composite_type` is the
nested type-signature list (e.g. ``[Similarity_h, Concept_h, Concept_h]``,
with sub-lists for nested sub-expressions), `elements` the target handles,
`hash_code` the atom's own handle.

The reference's `to_dict()` emitted a MongoDB document (key_0/key_1 vs a
`keys` list split by arity).  The TPU build stores atoms columnar — see
`das_tpu_torch.storage.atom_table` — but `to_dict()` is kept for API-parity
surfaces (`get_atom_as_dict`) and checkpoint metadata.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, List, Optional


@dataclass
class Expression:
    toplevel: bool = False
    ordered: bool = True
    terminal_name: Optional[str] = None
    typedef_name: Optional[str] = None
    typedef_name_hash: Optional[str] = None
    symbol_name: Optional[str] = None
    named_type: Optional[str] = None
    named_type_hash: Optional[str] = None
    composite_type: Optional[List[Any]] = None
    composite_type_hash: Optional[str] = None
    elements: Optional[List[str]] = None
    hash_code: Optional[str] = None

    def __hash__(self):
        return hash(self.hash_code)

    @property
    def is_terminal(self) -> bool:
        return self.terminal_name is not None

    @property
    def is_typedef(self) -> bool:
        return self.typedef_name is not None

    @property
    def arity(self) -> int:
        return len(self.elements) if self.elements else 0

    def to_dict(self) -> dict:
        assert self.ordered
        answer = {
            "_id": self.hash_code,
            "composite_type_hash": self.composite_type_hash,
        }
        if self.typedef_name is not None:
            answer["named_type"] = self.typedef_name
            answer["named_type_hash"] = self.typedef_name_hash
        elif self.terminal_name is not None:
            answer["name"] = self.terminal_name
            answer["named_type"] = self.named_type
        else:
            answer["is_toplevel"] = self.toplevel
            answer["composite_type"] = self.composite_type
            answer["named_type"] = self.named_type
            answer["named_type_hash"] = self.named_type_hash
            arity = len(self.elements)
            assert arity > 0
            if arity > 2:
                answer["keys"] = self.elements
            else:
                answer["key_0"] = self.elements[0]
                if arity > 1:
                    answer["key_1"] = self.elements[1]
        return answer

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=False, indent=4)
