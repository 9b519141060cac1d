"""In-memory DBInterface backend over `AtomSpaceData`.

This is simultaneously (a) the hardware-free test backend (role of the
reference StubDB, reference das/database/stub_db.py:20-188) and (b) a
complete, correct production backend for small/medium KBs (role of
RedisMongoDB, reference das/database/redis_mongo_db.py:49-335) — same
md5 handles, same answer sets.

Two deliberate semantic consolidations vs. the reference pair (which
disagree with each other):

* Unordered (Set/Similarity) wildcard probes use *multiset containment
  with multiplicity*: a link matches iff every grounded probe target is
  present among the link's targets often enough.  The reference production
  path approximates this through probe-target sorting against a
  materialized key fan-out (redis_mongo_db.py:249-251) — identical answers
  whenever the KB stores the symmetric closure (as its sample/bench KBs
  do) — while its StubDB used membership without multiplicity, which
  crashes `Link._assign_variables` on duplicate grounded targets.
* Wildcard probes work at every arity.  The reference only materializes
  pattern keys for arity ≤ 3 (parser_threads.py:186-219), silently
  returning [] above; computed probes have no such cliff.  (The latent
  blacklist bug noted in SURVEY.md §7 — stale `keys` reuse — does not
  exist here because nothing is materialized.)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from das_tpu_torch.core.hashing import ExpressionHasher
from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES, WILDCARD
from das_tpu_torch.storage.atom_table import AtomSpaceData, LinkRec
from das_tpu_torch.storage.interface import DBInterface


class MemoryDB(DBInterface):
    #: subclasses that override every scan-based get_matched_* method with
    #: device probes (TensorDB) set this False so prefetch() skips building
    #: the handle scan lists — at columnar-ingest scale those lists would
    #: reconstruct tens of millions of records for indexes never read
    _needs_scan_indexes = True

    def __init__(self, data: Optional[AtomSpaceData] = None):
        self.data = data if data is not None else AtomSpaceData()
        self._by_type: Dict[str, List[str]] = {}
        self._by_ctype: Dict[str, List[str]] = {}
        self._by_arity: Dict[int, List[str]] = {}
        self._indexed_links = -1
        self.prefetch()

    def __repr__(self):
        return "<MemoryDB>"

    # -- index maintenance -------------------------------------------------

    def prefetch(self) -> None:
        """(Re)build type/template scan lists — the analogue of the
        reference's full-DB prefetch (redis_mongo_db.py:89-127).  Links are
        append-only (records are never removed outside clear_database,
        which replaces the whole AtomSpaceData), so an incremental pass
        over just the new tail keeps transaction commits O(delta)."""
        n = len(self.data.links)
        if self._indexed_links == n:
            return
        if not self._needs_scan_indexes:
            self._indexed_links = n
            return
        if self._indexed_links < 0 or self._indexed_links > n:
            self._by_type = {}
            self._by_ctype = {}
            self._by_arity = {}
            self._indexed_links = 0
        from itertools import islice

        new_handles = list(
            islice(reversed(self.data.links), n - self._indexed_links)
        )[::-1]
        for handle in new_handles:
            rec = self.data.links[handle]
            self._by_type.setdefault(rec.named_type_hash, []).append(handle)
            self._by_ctype.setdefault(rec.composite_type_hash, []).append(handle)
            self._by_arity.setdefault(len(rec.elements), []).append(handle)
        self._indexed_links = n

    def _type_hash(self, atom_type: str) -> str:
        return self.data.table.get_named_type_hash(atom_type)

    # -- DBInterface -------------------------------------------------------

    def node_exists(self, node_type: str, node_name: str) -> bool:
        return ExpressionHasher.terminal_hash(node_type, node_name) in self.data.nodes

    def link_exists(self, link_type: str, target_handles: List[str]) -> bool:
        handle = ExpressionHasher.expression_hash(
            self._type_hash(link_type), list(target_handles)
        )
        return handle in self.data.links

    def get_node_handle(self, node_type: str, node_name: str) -> str:
        return ExpressionHasher.terminal_hash(node_type, node_name)

    def get_link_handle(self, link_type: str, target_handles: List[str]) -> str:
        return ExpressionHasher.expression_hash(
            self._type_hash(link_type), list(target_handles)
        )

    def get_link_targets(self, link_handle: str) -> List[str]:
        rec = self.data.links.get(link_handle)
        if rec is None:
            raise ValueError(f"Invalid handle: {link_handle}")
        return list(rec.elements)

    def is_ordered(self, link_handle: str) -> bool:
        if link_handle not in self.data.links:
            raise ValueError(f"Invalid handle: {link_handle}")
        return True

    def _match_rec(
        self, rec: LinkRec, target_handles: List[str], unordered: bool
    ) -> bool:
        if unordered:
            remaining = list(rec.elements)
            for target in target_handles:
                if target == WILDCARD:
                    continue
                if target in remaining:
                    remaining.remove(target)
                else:
                    return False
            return True
        return all(
            probe == WILDCARD or probe == element
            for probe, element in zip(target_handles, rec.elements)
        )

    def get_matched_links(self, link_type: str, target_handles: List[str]):
        self.prefetch()
        if link_type != WILDCARD and WILDCARD not in target_handles:
            handle = self.get_link_handle(link_type, target_handles)
            return [handle] if handle in self.data.links else []
        # pattern_black_list: the reference never emits `patterns:` index
        # keys for blacklisted link types (parser_threads.py:41, 185), so
        # wildcard probes cannot see those links; grounded lookups and
        # template probes are unaffected.
        if link_type == WILDCARD:
            candidates = self._by_arity.get(len(target_handles), [])
            unordered = False
            # typed candidates are pre-vetted; only the type-wildcard scan
            # needs the per-record check (set: O(1) per candidate)
            black_list = set(self.data.pattern_black_list)
        else:
            if link_type in self.data.pattern_black_list:
                return []
            candidates = self._by_type.get(self._type_hash(link_type), [])
            unordered = link_type in UNORDERED_LINK_TYPES
            black_list = set()
        arity = len(target_handles)
        answer = []
        for handle in candidates:
            rec = self.data.links[handle]
            if len(rec.elements) != arity:
                continue
            if black_list and rec.named_type in black_list:
                continue
            if self._match_rec(rec, target_handles, unordered):
                answer.append((handle, tuple(rec.elements)))
        return answer

    def get_all_nodes(self, node_type: str, names: bool = False) -> List[str]:
        type_hash = self._type_hash(node_type)
        core = self.data.columnar
        if core is not None:
            # vectorized base scan + overlay filter (the lazy-view
            # iteration would reconstruct every record)
            tid = core.tid_of_name.get(node_type)
            sel = (
                np.flatnonzero(core.node_tid == tid)
                if tid is not None else np.empty(0, dtype=np.int64)
            )
            if names:
                out = [core.node_name(int(i)) for i in sel]
                out.extend(
                    rec.name
                    for rec in self.data.nodes.overlay.values()
                    if rec.named_type_hash == type_hash
                )
            else:
                out = [core.node_hex(int(i)) for i in sel]
                out.extend(
                    handle
                    for handle, rec in self.data.nodes.overlay.items()
                    if rec.named_type_hash == type_hash
                )
            return out
        if names:
            return [
                rec.name
                for rec in self.data.nodes.values()
                if rec.named_type_hash == type_hash
            ]
        return [
            handle
            for handle, rec in self.data.nodes.items()
            if rec.named_type_hash == type_hash
        ]

    def _hash_template(self, template: Union[str, List[Any]]):
        if isinstance(template, str):
            return self._type_hash(template)
        return [self._hash_template(el) for el in template]

    def _flatten_template_hash(self, hashed) -> str:
        if isinstance(hashed, str):
            return hashed
        return ExpressionHasher.composite_hash(
            [self._flatten_template_hash(el) for el in hashed]
        )

    def get_matched_type_template(self, template: List[Any]) -> List[Any]:
        self.prefetch()
        hashed = self._hash_template(template)
        template_hash = self._flatten_template_hash(hashed)
        return [
            (handle, tuple(self.data.links[handle].elements))
            for handle in self._by_ctype.get(template_hash, [])
        ]

    def get_matched_type(self, link_type: str) -> List[Any]:
        self.prefetch()
        return [
            (handle, tuple(self.data.links[handle].elements))
            for handle in self._by_type.get(self._type_hash(link_type), [])
        ]

    def get_node_name(self, node_handle: str) -> str:
        rec = self.data.nodes.get(node_handle)
        if rec is None:
            raise ValueError(f"Invalid handle: {node_handle}")
        return rec.name

    def get_matched_node_name(self, node_type: str, substring: str) -> List[str]:
        type_hash = self._type_hash(node_type)
        pattern = re.compile(substring)
        return [
            handle
            for handle, rec in self.data.nodes.items()
            if rec.named_type_hash == type_hash and pattern.search(rec.name)
        ]

    # -- optional surface --------------------------------------------------

    def _named_type_template(self, template) -> Any:
        reverse = self.data.named_type_hash_reverse
        if isinstance(template, str):
            return reverse.get(template)
        return [self._named_type_template(el) for el in template]

    def get_atom_as_dict(self, handle: str, arity: int = -1) -> dict:
        node = self.data.nodes.get(handle) if arity <= 0 else None
        if node is not None:
            return {"handle": handle, "type": node.named_type, "name": node.name}
        rec = self.data.links.get(handle)
        if rec is None:
            node = self.data.nodes.get(handle)
            if node is not None:
                return {"handle": handle, "type": node.named_type, "name": node.name}
            return {}
        return {
            "handle": handle,
            "type": rec.named_type,
            "template": self._named_type_template(rec.composite_type),
            "targets": list(rec.elements),
        }

    def get_atom_as_deep_representation(self, handle: str, arity: int = -1):
        node = self.data.nodes.get(handle)
        if node is not None:
            return {"type": node.named_type, "name": node.name}
        rec = self.data.links.get(handle)
        if rec is None:
            raise ValueError(f"Invalid handle: {handle}")
        return {
            "type": rec.named_type,
            "targets": [
                self.get_atom_as_deep_representation(t) for t in rec.elements
            ],
        }

    def count_atoms(self) -> Tuple[int, int]:
        return self.data.count_atoms()

    # convenience used by API layer / miners
    def get_link_type(self, link_handle: str) -> str:
        rec = self.data.links.get(link_handle)
        if rec is None:
            raise ValueError(f"Invalid handle: {link_handle}")
        return rec.named_type

    def get_node_type(self, node_handle: str) -> str:
        rec = self.data.nodes.get(node_handle)
        if rec is None:
            raise ValueError(f"Invalid handle: {node_handle}")
        return rec.named_type

    def get_incoming(self, handle: str) -> List[str]:
        return self.data.incoming_of(handle)
