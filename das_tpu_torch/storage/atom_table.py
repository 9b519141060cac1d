"""Columnar AtomSpace data: the single source of truth every backend reads.

The reference spreads the loaded KB over five Mongo collections and five
Redis key namespaces (SURVEY.md §2.2).  Here the whole AtomSpace is one
host-resident columnar structure:

  * `nodes`    — insertion-ordered dict  handle_hex -> NodeRec
  * `typedefs` — insertion-ordered dict  handle_hex -> TypedefRec
  * `links`    — insertion-ordered dict  handle_hex -> LinkRec

plus the accumulated `SymbolTable` (type hashes, parent types).

`finalize()` derives the *device-facing* representation.  TPU-first design
decision: md5 handles never reach the device — every atom gets a dense
**int32 global row id** (nodes first, then links bucket-major), link targets
are stored as row-id columns, and named types get their own small int32
registry.  Probe indexes are argsort permutations over exact int64 keys
(``type_id << 32 | target_row``), so wildcard-pattern lookups are
`searchsorted` range scans — replacing the reference's materialized
16-keys-per-link Redis fan-out (parser_threads.py:183-219) with computed,
collision-free range intersections.  An incoming-set CSR replaces the
`incomming_set` Redis namespace.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np

from das_tpu_torch.core.expression import Expression
from das_tpu_torch.core.hashing import hex_to_i64_bulk
from das_tpu_torch.ingest.metta import SymbolTable


@dataclass
class NodeRec:
    name: str
    named_type: str
    named_type_hash: str


@dataclass
class TypedefRec:
    name: str
    name_hash: str
    composite_type_hash: str
    designator_name: str


@dataclass
class LinkRec:
    named_type: str
    named_type_hash: str
    composite_type: list
    composite_type_hash: str
    elements: Tuple[str, ...]
    is_toplevel: bool


@dataclass
class LinkBucket:
    """Finalized device-facing columns for one link arity.

    All row references are *global* atom row ids (int32).  `targets_sorted`
    is the per-row canonically sorted target matrix used by unordered
    (multiset) probes.  `order_*` are argsort permutations into this
    bucket's local rows; `key_*` the corresponding sorted key arrays.
    """

    arity: int
    rows: np.ndarray            # [m] int32 — global atom row of each link
    type_id: np.ndarray         # [m] int32
    ctype: np.ndarray           # [m] int64 — composite_type_hash
    targets: np.ndarray         # [m, arity] int32 — global rows of targets
    targets_sorted: np.ndarray  # [m, arity] int32

    order_by_type: np.ndarray
    key_type: np.ndarray        # int32 sorted
    order_by_ctype: np.ndarray
    key_ctype: np.ndarray       # int64 sorted
    order_by_type_pos: List[np.ndarray]    # per position p
    key_type_pos: List[np.ndarray]         # int64 (type_id<<32)|target sorted
    order_by_pos: List[np.ndarray]         # per position p (any type)
    key_pos: List[np.ndarray]              # int32 sorted
    # unordered (multiset) probe index over canonically sorted targets
    order_by_type_spos: List[np.ndarray]
    key_type_spos: List[np.ndarray]

    @property
    def size(self) -> int:
        return int(self.rows.shape[0])

    @cached_property
    def has_dangling(self) -> bool:
        """Whether ANY target in this segment is a dangling (-1) element —
        computed once per segment and cached, so grounded trivial counts
        (fused.py trivial_plan_count) skip their per-row dangling scan for
        segments known clean even when dangling hexes exist elsewhere in
        the store (ADVICE r4).  Segments are rebuilt on commit, so the
        cache can never go stale."""
        return bool((self.targets < 0).any())


@dataclass
class Finalized:
    """Everything derived by finalize(): registries + buckets + CSR."""

    atom_count: int
    node_count: int
    hex_of_row: List[str]
    row_of_hex: Dict[str, int]
    # type registry
    type_names: List[str]
    type_id_of_hash: Dict[str, int]      # named_type_hash hex -> id
    node_type_id: np.ndarray             # [node_count] int32
    buckets: Dict[int, LinkBucket]
    # incoming-set CSR over global rows
    incoming_offsets: np.ndarray         # [atom_count+1] int32
    incoming_links: np.ndarray           # [E] int32 (global link rows)
    # element hexes that resolved to no row (sentinel -1 targets); consulted
    # by the incremental commit path (tensor_db.py refresh)
    dangling_hexes: set = None
    # [nodes, links] already appended to the row registries.  Several
    # backends may share one cached Finalized (e.g. a ShardedDB and its
    # tree-fallback TensorDB over the same AtomSpaceData); delta interning
    # (storage/delta.py) consults these counters so each atom is appended
    # exactly once no matter which backend commits first.  None = set
    # lazily from node_count/atom_count (restored checkpoints).
    interned: list = None


def _combine_type_pos(type_id: np.ndarray, target: np.ndarray) -> np.ndarray:
    return (type_id.astype(np.int64) << 32) | target.astype(np.int64)


def build_bucket(
    arity: int,
    entries: List[Tuple[str, "LinkRec"]],
    row_of_hex: Dict[str, int],
    type_id,
    incoming_pairs: List[Tuple[np.ndarray, np.ndarray]],
    dangling: Optional[set] = None,
) -> LinkBucket:
    """Columnize one arity's link records and build its probe indexes.
    Shared by the full `finalize()` and the incremental delta path
    (storage/tensor_db.py refresh): a delta is just a small bucket whose
    indexes get merged into the device-resident ones.

    Columnization runs as COLUMN-WISE bulk passes (C-level `map` over the
    row dict, one vectorized hex→int64 decode, numpy masks for the
    incoming pairs) — at the 27.9M-link reference scale the old per-row
    Python loop dominated finalize time several-fold.  `incoming_pairs`
    receives (target_rows, link_rows) ARRAY chunks, not tuples."""
    m = len(entries)
    recs = [rec for _, rec in entries]
    rows = np.fromiter(
        map(row_of_hex.__getitem__, (h for h, _ in entries)),
        dtype=np.int32, count=m,
    )
    # type ids: intern each distinct hash once, then one bulk map pass
    first_seen: Dict[str, str] = {}
    for rec in recs:
        if rec.named_type_hash not in first_seen:
            first_seen[rec.named_type_hash] = rec.named_type
    tid_of = {h: type_id(h, nt) for h, nt in first_seen.items()}
    tids = np.fromiter(
        map(tid_of.__getitem__, (rec.named_type_hash for rec in recs)),
        dtype=np.int32, count=m,
    )
    # composite-type hashes repeat heavily (one per link-type/arity
    # template): decode each distinct hex once, then one bulk map pass
    ct_hexes = list({rec.composite_type_hash for rec in recs})
    ct_of = dict(zip(ct_hexes, hex_to_i64_bulk(ct_hexes).tolist()))
    ctype = np.fromiter(
        map(ct_of.__getitem__, (rec.composite_type_hash for rec in recs)),
        dtype=np.int64, count=m,
    )
    targets = np.empty((m, arity), dtype=np.int32)
    for p in range(arity):
        col = [rec.elements[p] for rec in recs]
        try:
            targets[:, p] = np.fromiter(
                map(row_of_hex.__getitem__, col), dtype=np.int32, count=m
            )
        except KeyError:
            # dangling target(s) (partial KB): park on a sentinel.  The
            # hex is recorded so a later commit that supplies the atom
            # can force a full re-finalize (the incremental path can't
            # retro-patch sorted positional indexes).
            for i, element in enumerate(col):
                trow = row_of_hex.get(element)
                if trow is None:
                    if dangling is not None:
                        dangling.add(element)
                    trow = -1
                targets[i, p] = trow
    return bucket_from_columns(arity, rows, tids, ctype, targets, incoming_pairs)


def bucket_from_columns(
    arity: int,
    rows: np.ndarray,
    tids: np.ndarray,
    ctype: np.ndarray,
    targets: np.ndarray,
    incoming_pairs: List[Tuple[np.ndarray, np.ndarray]],
) -> LinkBucket:
    """Build a LinkBucket straight from already-columnized arrays (the
    columnar ingest path) — same probe-index
    semantics as build_bucket, no record objects."""
    for p in range(arity):
        mask = targets[:, p] >= 0
        if mask.all():
            incoming_pairs.append((targets[:, p], rows))
        else:
            incoming_pairs.append((targets[mask, p], rows[mask]))
    return _index_bucket(arity, rows, tids, ctype, targets)


def _index_bucket(arity, rows, tids, ctype, targets) -> LinkBucket:
    """The shared probe-index tail: argsort permutations + sorted keys."""
    targets_sorted = np.sort(targets, axis=1)

    order_by_type = np.argsort(tids, kind="stable")
    order_by_ctype = np.argsort(ctype, kind="stable")
    order_by_type_pos, key_type_pos = [], []
    order_by_pos, key_pos = [], []
    order_by_type_spos, key_type_spos = [], []
    for p in range(arity):
        k = _combine_type_pos(tids, targets[:, p])
        o = np.argsort(k, kind="stable")
        order_by_type_pos.append(o.astype(np.int32))
        key_type_pos.append(k[o])
        o2 = np.argsort(targets[:, p], kind="stable")
        order_by_pos.append(o2.astype(np.int32))
        key_pos.append(targets[:, p][o2])
        ks = _combine_type_pos(tids, targets_sorted[:, p])
        o3 = np.argsort(ks, kind="stable")
        order_by_type_spos.append(o3.astype(np.int32))
        key_type_spos.append(ks[o3])
    return LinkBucket(
        arity=arity,
        rows=rows,
        type_id=tids,
        ctype=ctype,
        targets=targets,
        targets_sorted=targets_sorted,
        order_by_type=order_by_type.astype(np.int32),
        key_type=tids[order_by_type],
        order_by_ctype=order_by_ctype.astype(np.int32),
        key_ctype=ctype[order_by_ctype],
        order_by_type_pos=order_by_type_pos,
        key_type_pos=key_type_pos,
        order_by_pos=order_by_pos,
        key_pos=key_pos,
        order_by_type_spos=order_by_type_spos,
        key_type_spos=key_type_spos,
    )


def host_segments(db, arity: int) -> List[LinkBucket]:
    """The backend's host-side column segments for one arity: base bucket
    plus incremental overlay segments when the backend provides them
    (IncrementalCommitMixin.host_bucket_segments), else the finalized
    bucket.  Their concatenation exactly mirrors the backend's merged
    device row space — shared by every host-side counting path
    (query/fused.py trivial_plan_count, query/starcount.py host fold)."""
    segments_of = getattr(db, "host_bucket_segments", None)
    if segments_of is not None:
        return segments_of(arity)
    b = db.fin.buckets.get(arity)
    return [b] if b is not None and b.size else []


def host_probe_locals(
    b: LinkBucket, type_id: int, fixed: Tuple[Tuple[int, int], ...]
) -> np.ndarray:
    """Bucket-local rows matching (type, grounded positions), probed on the
    host copies of the SAME sorted indexes the device kernels use: binary
    search the narrowest fixed position's (type<<32|target) range, then
    verify the remaining fixed positions with vectorized compares.  This is
    the one host-side probe algorithm — the fused single-term count and the
    star fold's sparse degree both call it, so probe semantics cannot
    diverge between editions."""
    best = None  # (range size, position, lo)
    for pos, val in fixed:
        key = (np.int64(type_id) << 32) | np.int64(val)
        keys = b.key_type_pos[pos]
        lo = int(np.searchsorted(keys, key, side="left"))
        hi = int(np.searchsorted(keys, key, side="right"))
        if best is None or hi - lo < best[0]:
            best = (hi - lo, pos, lo)
    n, pos, lo = best
    if n == 0:
        return np.empty(0, dtype=np.int32)
    local = b.order_by_type_pos[pos][lo : lo + n]
    ok = np.ones(n, dtype=bool)
    for q, v in fixed:
        if q != pos:
            ok &= b.targets[local, q] == v
    return local[ok]


class AtomSpaceData:
    """Mutable host store + derived columnar representation."""

    def __init__(self, symbol_table: Optional[SymbolTable] = None):
        self.table = symbol_table if symbol_table is not None else SymbolTable()
        self.nodes: Dict[str, NodeRec] = {}
        self.typedefs: Dict[str, TypedefRec] = {}
        self.links: Dict[str, LinkRec] = {}
        self._fin: Optional[Finalized] = None
        self.pattern_black_list: List[str] = []

    # -- ingestion ---------------------------------------------------------

    def add_typedef(self, expr: Expression) -> None:
        if expr.hash_code in self.typedefs:
            return
        self.typedefs[expr.hash_code] = TypedefRec(
            name=expr.typedef_name,
            name_hash=expr.typedef_name_hash,
            composite_type_hash=expr.composite_type_hash,
            designator_name=self.table.named_types.get(expr.typedef_name, ""),
        )

    def add_terminal(self, expr: Expression) -> None:
        if expr.hash_code in self.nodes:
            return
        self.nodes[expr.hash_code] = NodeRec(
            name=expr.terminal_name,
            named_type=expr.named_type,
            named_type_hash=expr.named_type_hash,
        )
        self._fin = None

    def add_link(self, expr: Expression) -> None:
        if expr.hash_code in self.links:
            if expr.toplevel:
                self.links[expr.hash_code].is_toplevel = True
            return
        self.links[expr.hash_code] = LinkRec(
            named_type=expr.named_type,
            named_type_hash=expr.named_type_hash,
            composite_type=expr.composite_type,
            composite_type_hash=expr.composite_type_hash,
            elements=tuple(expr.elements),
            is_toplevel=expr.toplevel,
        )
        self._fin = None

    def add_expression(self, expr: Expression) -> None:
        if expr.is_typedef:
            self.add_typedef(expr)
        elif expr.is_terminal:
            self.add_terminal(expr)
        else:
            self.add_link(expr)

    # -- host-side incoming map (lazy, for miners / API) -------------------

    def incoming_of(self, handle: str) -> List[str]:
        fin = self.finalize()
        row = fin.row_of_hex.get(handle)
        if row is None:
            return []
        lo, hi = fin.incoming_offsets[row], fin.incoming_offsets[row + 1]
        return [fin.hex_of_row[r] for r in fin.incoming_links[lo:hi]]

    # -- finalization ------------------------------------------------------

    def finalize(self) -> Finalized:
        if self._fin is not None:
            return self._fin
        node_hexes = list(self.nodes.keys())
        by_arity: Dict[int, List[Tuple[str, LinkRec]]] = {}
        for hex_handle, rec in self.links.items():
            by_arity.setdefault(len(rec.elements), []).append((hex_handle, rec))
        arities = sorted(by_arity)

        hex_of_row: List[str] = list(node_hexes)
        for arity in arities:
            hex_of_row.extend(h for h, _ in by_arity[arity])
        row_of_hex = {h: i for i, h in enumerate(hex_of_row)}
        atom_count = len(hex_of_row)
        node_count = len(node_hexes)

        # type registry
        type_names: List[str] = []
        type_id_of_hash: Dict[str, int] = {}

        def type_id(named_type_hash: str, named_type: str) -> int:
            tid = type_id_of_hash.get(named_type_hash)
            if tid is None:
                tid = len(type_names)
                type_id_of_hash[named_type_hash] = tid
                type_names.append(named_type)
            return tid

        node_type_id = np.empty(node_count, dtype=np.int32)
        for i, h in enumerate(node_hexes):
            rec = self.nodes[h]
            node_type_id[i] = type_id(rec.named_type_hash, rec.named_type)

        buckets: Dict[int, LinkBucket] = {}
        # (target_rows, link_rows) array chunks from each bucket build
        incoming_pairs: List[Tuple[np.ndarray, np.ndarray]] = []
        dangling: set = set()
        for arity in arities:
            buckets[arity] = build_bucket(
                arity, by_arity[arity], row_of_hex, type_id, incoming_pairs,
                dangling,
            )

        # incoming CSR
        trows = (
            np.concatenate([t for t, _ in incoming_pairs])
            if incoming_pairs else np.empty(0, dtype=np.int32)
        )
        lrows = (
            np.concatenate([l for _, l in incoming_pairs])
            if incoming_pairs else np.empty(0, dtype=np.int32)
        )
        incoming_offsets = np.zeros(atom_count + 1, dtype=np.int32)
        incoming_links = np.empty(trows.shape[0], dtype=np.int32)
        if trows.size:
            order = np.argsort(trows, kind="stable")
            incoming_links = lrows[order].copy()
            counts = np.bincount(trows, minlength=atom_count)
            incoming_offsets[1:] = np.cumsum(counts, dtype=np.int32)

        self._fin = Finalized(
            atom_count=atom_count,
            node_count=node_count,
            hex_of_row=hex_of_row,
            row_of_hex=row_of_hex,
            type_names=type_names,
            type_id_of_hash=type_id_of_hash,
            node_type_id=node_type_id,
            buckets=buckets,
            incoming_offsets=incoming_offsets,
            incoming_links=incoming_links,
            dangling_hexes=dangling,
            interned=[node_count, atom_count - node_count],
        )
        return self._fin

    # -- introspection -----------------------------------------------------

    def count_atoms(self) -> Tuple[int, int]:
        return (len(self.nodes), len(self.links))

    @property
    def named_type_hash_reverse(self) -> Dict[str, str]:
        return {v: k for k, v in self.table.named_type_hash.items()}


def load_metta_text(text: str, data: Optional[AtomSpaceData] = None) -> AtomSpaceData:
    """Parse MeTTa source straight into an AtomSpaceData."""
    from das_tpu_torch.ingest.metta import MettaParser

    if data is None:
        data = AtomSpaceData()
    typedefs: List[Expression] = []
    terminals: List[Expression] = []
    regular: List[Expression] = []
    parser = MettaParser(
        symbol_table=data.table,
        on_typedef=typedefs.append,
        on_terminal=terminals.append,
        on_expression=regular.append,
        on_toplevel=regular.append,
    )
    parser.parse(text)
    # records may have been completed by the EOF fixpoint — route them now
    for expr in typedefs:
        data.add_typedef(expr)
    for expr in terminals:
        data.add_terminal(expr)
    for expr in regular:
        data.add_link(expr)
    return data


def load_metta_file(path: str, data: Optional[AtomSpaceData] = None) -> AtomSpaceData:
    with open(path, "r") as fh:
        return load_metta_text(fh.read(), data)
