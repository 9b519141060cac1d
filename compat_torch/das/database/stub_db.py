"""The `das` package's StubDB (reference das/database/stub_db.py:20-188)
over das_tpu_torch.

The reference StubDB is a dict fake over a small animals fixture with
readable handles (`<Concept: human>`), which its pattern-matcher unit
tests query.  Here the same fixture loads through the port's MeTTa parser
into a MemoryDB, every DBInterface method delegates to it, and md5
handles are translated to and from the readable form at the boundary.

Readable handles (reference stub_db.py:8-18):
  node  ``<Type: name>``
  link  ``<Type: [target_handles...]>``, targets sorted for the unordered
        types.
"""

from typing import Any, List, Tuple

from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES, WILDCARD
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.interface import DBInterface
from das_tpu_torch.storage.memory_db import MemoryDB

#: the reference stub's fixture, 1:1 (stub_db.py:24-72).  It is not
#: animals.metta: each Similarity link appears in one orientation only (the
#: sample file stores both), and the List and Set links are extra
_STUB_FIXTURE = """
(: Similarity Type)
(: Concept Type)
(: Inheritance Type)
(: List Type)
(: Set Type)
(: "human" Concept)
(: "monkey" Concept)
(: "chimp" Concept)
(: "snake" Concept)
(: "earthworm" Concept)
(: "rhino" Concept)
(: "triceratops" Concept)
(: "vine" Concept)
(: "ent" Concept)
(: "mammal" Concept)
(: "animal" Concept)
(: "reptile" Concept)
(: "dinosaur" Concept)
(: "plant" Concept)
(Similarity "human" "monkey")
(Similarity "human" "chimp")
(Similarity "chimp" "monkey")
(Similarity "snake" "earthworm")
(Similarity "rhino" "triceratops")
(Similarity "snake" "vine")
(Similarity "human" "ent")
(Inheritance "human" "mammal")
(Inheritance "monkey" "mammal")
(Inheritance "chimp" "mammal")
(Inheritance "mammal" "animal")
(Inheritance "reptile" "animal")
(Inheritance "snake" "reptile")
(Inheritance "dinosaur" "reptile")
(Inheritance "triceratops" "dinosaur")
(Inheritance "earthworm" "animal")
(Inheritance "rhino" "mammal")
(Inheritance "vine" "plant")
(Inheritance "ent" "plant")
(List (Inheritance "dinosaur" "reptile") (Inheritance "triceratops" "dinosaur"))
(Set (Inheritance "dinosaur" "reptile") (Inheritance "triceratops" "dinosaur"))
(List "human" "ent" "monkey" "chimp")
(List "human" "mammal" "triceratops" "vine")
(List "human" "monkey" "chimp")
(List "triceratops" "ent" "monkey" "snake")
(Set "triceratops" "vine" "monkey" "snake")
(Set "triceratops" "ent" "monkey" "snake")
(Set "human" "ent" "monkey" "chimp")
(Set "mammal" "monkey" "human" "chimp")
(Set "human" "monkey" "chimp")
"""


def _build_node_handle(node_type: str, node_name: str) -> str:
    return f"<{node_type}: {node_name}>"


class StubDB(DBInterface):
    def __init__(self):
        data = load_metta_text(_STUB_FIXTURE)
        self._db = MemoryDB(data)
        self._readable = {}
        self._md5 = {}
        for h, node in data.nodes.items():
            r = _build_node_handle(node.named_type, node.name)
            self._readable[h] = r
            self._md5[r] = h

        def readable(h: str) -> str:
            cached = self._readable.get(h)
            if cached is not None:
                return cached
            link = data.links[h]
            targets = [readable(t) for t in link.elements]
            if link.named_type in UNORDERED_LINK_TYPES:
                targets = sorted(targets)
            r = f"<{link.named_type}: {targets}>"
            self._readable[h] = r
            self._md5[r] = h
            return r

        for h in list(data.links):
            readable(h)

    # -- handle translation ------------------------------------------------

    def _to_md5(self, handle: str) -> str:
        if handle == WILDCARD:
            return WILDCARD
        return self._md5.get(handle, handle)

    def _to_readable(self, handle: str) -> str:
        return self._readable.get(handle, handle)

    # -- DBInterface -------------------------------------------------------

    def node_exists(self, node_type: str, node_name: str) -> bool:
        return self._db.node_exists(node_type, node_name)

    def link_exists(self, link_type: str, target_handles: List[str]) -> bool:
        # an unordered link exists as a multiset: the readable handle sorts
        # the targets of the unordered types, so Set and Similarity probes
        # do not depend on the caller's order
        return self.get_link_handle(link_type, target_handles) in self._md5

    def get_node_handle(self, node_type: str, node_name: str) -> str:
        return _build_node_handle(node_type, node_name)

    def get_link_handle(self, link_type: str, target_handles: List[str]) -> str:
        targets = list(target_handles)
        if link_type in UNORDERED_LINK_TYPES:
            targets = sorted(targets)
        return f"<{link_type}: {targets}>"

    def get_link_targets(self, link_handle: str) -> List[str]:
        return [
            self._to_readable(t)
            for t in self._db.get_link_targets(self._to_md5(link_handle))
        ]

    def is_ordered(self, link_handle: str) -> bool:
        return self._db.is_ordered(self._to_md5(link_handle))

    def _translate_matches(self, matches) -> List[Any]:
        out = []
        for item in matches:
            if isinstance(item, str):
                out.append(self._to_readable(item))
            else:
                handle, targets = item
                out.append(
                    [
                        self._to_readable(handle),
                        [self._to_readable(t) for t in targets],
                    ]
                )
        return out

    def get_matched_links(self, link_type: str, target_handles: List[str]):
        return self._translate_matches(
            self._db.get_matched_links(
                link_type, [self._to_md5(t) for t in target_handles]
            )
        )

    def get_matched_type_template(self, template: List[Any]) -> List[Any]:
        return self._translate_matches(
            self._db.get_matched_type_template(template)
        )

    def get_matched_type(self, link_type: str) -> List[Any]:
        return self._translate_matches(self._db.get_matched_type(link_type))

    def get_all_nodes(self, node_type: str, names: bool = False) -> List[str]:
        if names:
            return self._db.get_all_nodes(node_type, names=True)
        return [
            self._to_readable(h) for h in self._db.get_all_nodes(node_type)
        ]

    def get_node_name(self, node_handle: str) -> str:
        return self._db.get_node_name(self._to_md5(node_handle))

    def get_matched_node_name(self, node_type: str, substring: str) -> List[str]:
        return [
            self._to_readable(h)
            for h in self._db.get_matched_node_name(node_type, substring)
        ]

    def get_atom_as_dict(self, handle: str, arity: int = -1) -> dict:
        return self._db.get_atom_as_dict(self._to_md5(handle), arity)

    def get_atom_as_deep_representation(self, handle: str, arity: int = -1):
        return self._db.get_atom_as_deep_representation(
            self._to_md5(handle), arity
        )

    def count_atoms(self) -> Tuple[int, int]:
        return self._db.count_atoms()
