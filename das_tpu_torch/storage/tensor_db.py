"""Device-resident AtomSpace backend (port of `das_tpu/storage/tensor_db.py`).

At construction every finalized bucket (storage/atom_table.py) is copied
to the chosen device as torch tensors, padded to its capacity class with
the same per-dtype sentinels as the JAX store: sorted keys pad to the
dtype max (so they sort last and no real probe key can hit them),
`targets`/`targets_sorted` to -2, `rows`/`type_id` to -1, permutations to
0.  The compiled conjunctive path (query/compiler.py, query/fused.py)
reads the tensors through `.dev`.

`device=None` means CUDA: without a card the constructor raises rather
than moving quietly to the CPU.  Tests pass `device="cpu"`, and the
kernel wrappers then take their plain PyTorch versions.

A commit is incremental (storage/delta.py): `refresh()` interns the new
atoms, merges each arity's small delta bucket into the capacity slack of
the device tensors, and re-finalizes only when the delta path is unsafe
or the overlay passed `config.delta_merge_threshold`.  Merged tensors are
always new tensors, never a live one written in place, so a batch
dispatched before the commit still reads the tables it was planned on.
Under a snapshot root every commit is logged first (storage/durable.py),
and `TensorDB.restore` brings a store back from its snapshots."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import CapacityOverflowError
from das_tpu_torch.core.hashing import hex_to_i64
from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES, WILDCARD
from das_tpu_torch.ops import posting
from das_tpu_torch.storage.atom_table import AtomSpaceData, Finalized, LinkBucket
from das_tpu_torch.storage.delta import (
    FULL,
    NOOP,
    IncrementalCommitMixin,
    capacity_class,
    delta_class,
    merge_sorted_index,
)
from das_tpu_torch.storage.memory_db import MemoryDB


def resolve_device(device=None) -> torch.device:
    """The port's device rule: None means CUDA, and asking for CUDA with
    no card raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "das_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch route"
        )
    return dev


@dataclass
class DeviceBucket:
    """One arity's link columns and probe indexes on the device, padded to
    `capacity` rows (`size` real rows)."""

    arity: int
    size: int
    capacity: int
    rows: torch.Tensor
    type_id: torch.Tensor
    ctype: torch.Tensor
    targets: torch.Tensor
    targets_sorted: torch.Tensor
    order_by_type: torch.Tensor
    key_type: torch.Tensor
    order_by_ctype: torch.Tensor
    key_ctype: torch.Tensor
    order_by_type_pos: List[torch.Tensor]
    key_type_pos: List[torch.Tensor]
    order_by_pos: List[torch.Tensor]
    key_pos: List[torch.Tensor]
    order_by_type_spos: List[torch.Tensor]
    key_type_spos: List[torch.Tensor]


#: DeviceBucket tensor fields with their pad value; None = the dtype max
#: (sorted key columns)
BUCKET_PADS = (
    ("rows", -1), ("type_id", -1), ("ctype", None), ("targets", -2),
    ("targets_sorted", -2), ("order_by_type", 0), ("key_type", None),
    ("order_by_ctype", 0), ("key_ctype", None),
)
BUCKET_LIST_PADS = (
    ("order_by_type_pos", 0), ("key_type_pos", None), ("order_by_pos", 0),
    ("key_pos", None), ("order_by_type_spos", 0), ("key_type_spos", None),
)


def _pad_rows(x: np.ndarray, capacity: int, fill) -> np.ndarray:
    n = x.shape[0]
    if n >= capacity:
        return x
    if fill is None:
        fill = np.iinfo(x.dtype).max
    out = np.full((capacity, *x.shape[1:]), fill, dtype=x.dtype)
    out[:n] = x
    return out


def _next_capacity(count: int, current: int, maximum: int) -> int:
    """The capacity after an overflow: doubled from `current` until it
    holds `count`, at most `maximum` (past it, CapacityOverflowError)."""
    if count > maximum:
        raise CapacityOverflowError(
            f"probe needs {count} rows > max_result_capacity {maximum}"
        )
    cap = max(current, 16)
    while cap < count:
        cap *= 2
    return min(cap, maximum)


def upload_bucket(b: LinkBucket, device) -> DeviceBucket:
    """Copy every column/index of one finalized bucket to `device`, padded
    to its capacity class (see DeviceBucket)."""
    cap = capacity_class(b.size)

    def put(x, fill):
        return torch.from_numpy(np.ascontiguousarray(_pad_rows(x, cap, fill))).to(device)

    fields = {name: put(getattr(b, name), fill) for name, fill in BUCKET_PADS}
    for name, fill in BUCKET_LIST_PADS:
        fields[name] = [put(x, fill) for x in getattr(b, name)]
    return DeviceBucket(arity=b.arity, size=b.size, capacity=cap, **fields)


class DeviceTables:
    """All device-resident tensors for one AtomSpace."""

    def __init__(self, fin: Optional[Finalized], device):
        self.device = device
        self.buckets: Dict[int, DeviceBucket] = {}
        if fin is None:
            return
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
        self.node_type_id = put(fin.node_type_id)
        self.incoming_offsets = put(fin.incoming_offsets)
        self.incoming_links = put(fin.incoming_links)
        self.buckets = {
            arity: upload_bucket(b, device) for arity, b in fin.buckets.items()
        }

    def nbytes(self) -> int:
        """Bytes held by the store's tensors."""
        total = sum(
            t.numel() * t.element_size()
            for t in (self.node_type_id, self.incoming_offsets, self.incoming_links)
        )
        for b in self.buckets.values():
            for name, _ in BUCKET_PADS:
                t = getattr(b, name)
                total += t.numel() * t.element_size()
            for name, _ in BUCKET_LIST_PADS:
                total += sum(t.numel() * t.element_size() for t in getattr(b, name))
        return total


def _merge_padded(base_keys, base_perm, delta_keys, delta_perm):
    """Sorted-index merge into a capacity-padded base at a fixed length:
    delta pad entries (dtype-max keys) sort past the base's pad region and
    fall off the final cut, so the tensor length never changes."""
    cap = base_keys.shape[0]
    k, p = merge_sorted_index(base_keys, base_perm, delta_keys, delta_perm)
    return k[:cap], p[:cap]


def _insert_rows(col: torch.Tensor, block: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of `col` with the fixed-size delta `block` written at row n
    (the live column is never written)."""
    out = col.clone()
    out[n:n + block.shape[0]] = block
    return out


class TensorDB(IncrementalCommitMixin, MemoryDB):
    """MemoryDB whose finalized columns also live on a torch device.
    Compiled queries run on the device tables through `.dev`, and the
    DBInterface probes (`get_matched_links`, `get_matched_type_template`,
    `get_matched_type`) are answered by range probes of the device's
    sorted posting columns instead of MemoryDB's host scans.  The rest of
    the DBInterface surface is MemoryDB's; `get_incoming` and the commit
    path come from IncrementalCommitMixin."""

    _needs_scan_indexes = False

    def __init__(self, data: Optional[AtomSpaceData] = None,
                 config: Optional[DasConfig] = None, device=None):
        self.device = resolve_device(device)
        super().__init__(data)
        self.config = config or DasConfig()
        self.fin: Finalized = self.data.finalize()
        self.dev = DeviceTables(self.fin, self.device)
        self._reset_delta_state()

    def __repr__(self):
        return "<TensorDB>"

    def refresh(self) -> None:
        """Re-sync the device store after host-side mutations (transaction
        commits, loads).  A small delta takes the incremental path: only
        the new records are columnized, only they travel to the device,
        and each sorted posting index is extended by an O(n) merge.  Past
        config.delta_merge_threshold overlay atoms, or where a delta is
        unsafe (storage/delta.py _plan_refresh), the store is re-finalized
        and re-uploaded.  Every outcome but NOOP advances `delta_version`;
        the full path also replaces `.dev`, which drops the cached fused
        executor."""
        self.prefetch()
        action = self._plan_refresh()
        if action == NOOP:
            return
        if action == FULL:
            # a rebuild consumes host mutations the incremental log would
            # miss: log the pending tail (fsynced) before the rebuild, at
            # the version _reset_delta_state lands on
            wal = self._wal
            if wal is not None:
                wal.append(self.data, self.delta_version + 1, kind="full")
            self.fin = self.data.finalize()
            self.dev = DeviceTables(self.fin, self.device)
            self._reset_delta_state()
            return
        self._commit_delta_with_retry(action)

    @classmethod
    def restore(cls, path: str, config: Optional[DasConfig] = None,
                device=None) -> "TensorDB":
        """The newest valid snapshot generation under `path`, its WAL
        replayed to the head, and its warm bundle (storage/durable.py
        restore); commits on the restored store append to the
        generation's WAL.  `device=None` means CUDA."""
        from das_tpu_torch.storage import durable

        return durable.restore(path, config=config, backend="tensor", device=device)

    # -- the device half of an incremental commit ----------------------------

    def _grow_bucket(self, base: DeviceBucket, new_cap: int) -> DeviceBucket:
        """Re-pad a bucket to a larger capacity class (only when commits
        exhaust the ~6% slack).  Real rows, and the real sorted keys and
        perms in the leading positions, are kept; the new slack holds each
        field's pad."""
        n = base.size

        def grow(t, fill):
            if fill is None:
                fill = torch.iinfo(t.dtype).max
            pad = torch.full((new_cap - n, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
            return torch.cat([t[:n], pad], dim=0)

        fields = {name: grow(getattr(base, name), fill) for name, fill in BUCKET_PADS}
        for name, fill in BUCKET_LIST_PADS:
            fields[name] = [grow(t, fill) for t in getattr(base, name)]
        return DeviceBucket(arity=base.arity, size=n, capacity=new_cap, **fields)

    def _stage_delta_merge(self, delta: LinkBucket):
        """Compute a commit bucket's merge into the device tables and return
        (swap, became_base, slots): `swap` is the deferred assignment that
        makes the merged bucket visible (storage/delta.py _apply_delta),
        became_base when the delta is the first bucket of its arity, slots
        the device rows it occupies (the delta's size).  Every merged
        column is a new tensor, so nothing visible changes until `swap`."""
        arity = delta.arity
        base = self.dev.buckets.get(arity)
        if base is None or base.size == 0:
            # first links of this arity: the delta is the base
            merged = upload_bucket(delta, self.device)

            def swap():
                self.dev.buckets[arity] = merged

            return swap, True, delta.size
        n, d = base.size, delta.size
        dcap = delta_class(d)
        if n + dcap > base.capacity:
            base = self._grow_bucket(base, capacity_class(n + dcap))

        def dpad(x, fill):
            return torch.from_numpy(np.ascontiguousarray(_pad_rows(x, dcap, fill))).to(
                self.device)

        def merge(bk, bo, dk, do):
            # the delta's perm is offset into the merged row space on the host
            return _merge_padded(bk, bo, dpad(dk, None), dpad(do.astype(np.int32) + n, 0))

        fields = {}
        for keys, order in (("key_type_pos", "order_by_type_pos"), ("key_pos", "order_by_pos"),
                            ("key_type_spos", "order_by_type_spos")):
            pairs = [merge(bk, bo, dk, do) for bk, bo, dk, do in zip(
                getattr(base, keys), getattr(base, order),
                getattr(delta, keys), getattr(delta, order))]
            fields[keys] = [k for k, _ in pairs]
            fields[order] = [o for _, o in pairs]
        for keys, order in (("key_type", "order_by_type"), ("key_ctype", "order_by_ctype")):
            fields[keys], fields[order] = merge(getattr(base, keys), getattr(base, order),
                                                getattr(delta, keys), getattr(delta, order))
        for name in ("rows", "type_id", "ctype", "targets", "targets_sorted"):
            fill = dict(BUCKET_PADS)[name]
            fields[name] = _insert_rows(getattr(base, name), dpad(getattr(delta, name), fill), n)
        merged = DeviceBucket(arity=arity, size=n + d, capacity=base.capacity, **fields)

        def swap():
            self.dev.buckets[arity] = merged

        return swap, False, d

    # -- low-level lookups (shared with the query compiler) ----------------

    def _type_id(self, link_type: str) -> Optional[int]:
        h = self.data.table.get_named_type_hash(link_type)
        return self.fin.type_id_of_hash.get(h)

    def _row_of(self, handle_hex: str) -> Optional[int]:
        return self.fin.row_of_hex.get(handle_hex)

    # -- device probes (shared with the tree executor) ---------------------

    def probe_ordered_padded(self, arity: int, type_id: Optional[int],
                             fixed: Tuple[Tuple[int, int], ...]):
        """Padded device probe with capacity retry: (local, mask) device
        tensors, or None when the bucket is empty."""
        db = self.dev.buckets.get(arity)
        if db is None or db.size == 0:
            return None
        cap = min(self.config.initial_result_capacity, max(db.size, 16))
        while True:
            local, mask, range_count = self._probe_ordered_padded(db, type_id, fixed, cap)
            # overflow is judged on the *range* count (the pre-verification
            # superset): candidates beyond `cap` were never verified
            if int(range_count) <= cap:
                return local, mask
            cap = _next_capacity(int(range_count), cap, self.config.max_result_capacity)

    def probe_ordered(self, arity: int, type_id: Optional[int],
                      fixed: Tuple[Tuple[int, int], ...]) -> np.ndarray:
        """Bucket-local rows matching a positional wildcard pattern.
        `fixed` = ((position, global_target_row), ...).  Returns int32[n]."""
        padded = self.probe_ordered_padded(arity, type_id, fixed)
        if padded is None:
            return np.empty(0, dtype=np.int32)
        return _selected(*padded)

    def _probe_ordered_padded(self, db: DeviceBucket, type_id, fixed, cap: int):
        """One padded probe round: (local, verified_mask, range_count)."""
        if type_id is not None and fixed:
            p0, v0 = fixed[0]
            key = (int(type_id) << 32) | int(v0)
            local, valid, range_count = posting.range_probe(
                db.key_type_pos[p0], db.order_by_type_pos[p0], key, cap)
            mask = posting.verify_positions(
                db.targets, db.type_id, local, valid, -1, tuple(fixed[1:]))
        elif type_id is not None:
            local, valid, range_count = posting.range_probe(
                db.key_type, db.order_by_type, int(type_id), cap)
            mask = valid
        elif fixed:
            p0, v0 = fixed[0]
            local, valid, range_count = posting.range_probe(
                db.key_pos[p0], db.order_by_pos[p0], int(v0), cap)
            mask = posting.verify_positions(
                db.targets, db.type_id, local, valid, -1, tuple(fixed[1:]))
        else:
            local, valid, range_count = posting.full_scan(db.size, cap, db.targets.device)
            mask = valid
        return local, mask, range_count

    def probe_unordered_padded(self, arity: int, type_id: Optional[int],
                               required: Tuple[Tuple[int, int], ...]):
        """Padded unordered (multiset) probe: (local, mask) device tensors,
        or None when the bucket is empty.  Candidates contain every
        required (global_row, count) with multiplicity, at any position:
        every position is probed for the first required row, the windows
        are concatenated and deduplicated, then the multiset verified."""
        db = self.dev.buckets.get(arity)
        if db is None or db.size == 0:
            return None
        if not required:
            return self.probe_ordered_padded(arity, type_id, ())
        cap = min(self.config.initial_result_capacity, max(db.size * arity, 16))
        v0 = int(required[0][0])
        while True:
            locals_, valids, counts = [], [], []
            for p in range(arity):
                if type_id is not None:
                    local, valid, range_count = posting.range_probe(
                        db.key_type_spos[p], db.order_by_type_spos[p],
                        (int(type_id) << 32) | v0, cap)
                else:
                    local, valid, range_count = posting.range_probe(
                        db.key_pos[p], db.order_by_pos[p], v0, cap)
                locals_.append(local)
                valids.append(valid)
                counts.append(range_count)
            max_range = int(torch.stack(counts).max())
            if max_range > cap:
                cap = _next_capacity(max_range, cap, self.config.max_result_capacity)
                continue
            local, keep = posting.dedup_sorted(torch.cat(locals_), torch.cat(valids))
            mask = posting.verify_multiset(
                db.targets, db.type_id, local, keep,
                -1 if type_id is None else int(type_id), tuple(required))
            return local, mask

    def probe_unordered(self, arity: int, type_id: Optional[int],
                        required: Tuple[Tuple[int, int], ...]) -> np.ndarray:
        """Bucket-local rows containing every required (global_row, count)
        with multiplicity, irrespective of position."""
        padded = self.probe_unordered_padded(arity, type_id, required)
        if padded is None:
            return np.empty(0, dtype=np.int32)
        return _selected(*padded)

    def probe_ctype_padded(self, arity: int, ctype_i64: int):
        """Padded template-index probe for one arity bucket."""
        db = self.dev.buckets.get(arity)
        if db is None or db.size == 0:
            return None
        cap = min(self.config.initial_result_capacity, max(db.size, 16))
        while True:
            local, valid, count = posting.range_probe(
                db.key_ctype, db.order_by_ctype, int(ctype_i64), cap)
            if int(count) <= cap:
                return local, valid
            cap = _next_capacity(int(count), cap, self.config.max_result_capacity)

    def probe_ctype(self, ctype_i64: int) -> Dict[int, np.ndarray]:
        """Rows per arity whose composite type hash matches (template index)."""
        out = {}
        for arity in self.dev.buckets:
            padded = self.probe_ctype_padded(arity, ctype_i64)
            if padded is None:
                continue
            sel = _selected(*padded)
            if sel.size:
                out[arity] = sel
        return out

    def _materialize(self, arity: int, local_rows: np.ndarray):
        """Bucket-local rows -> (handle, target hexes); locals past the base
        bucket's size index the per-commit delta overlay segments."""
        segments = self.host_bucket_segments(arity)
        hexes = self.fin.hex_of_row
        out = []
        for i in local_rows:
            j = int(i)
            for b in segments:
                if j < b.size:
                    break
                j -= b.size
            row = int(b.rows[j])
            tg = tuple(hexes[int(t)] if int(t) >= 0 else WILDCARD for t in b.targets[j])
            out.append((hexes[row], tg))
        return out

    # -- DBInterface probe overrides ---------------------------------------

    def get_matched_links(self, link_type: str, target_handles: List[str]):
        if link_type != WILDCARD and WILDCARD not in target_handles:
            handle = self.get_link_handle(link_type, target_handles)
            return [handle] if handle in self.data.links else []
        arity = len(target_handles)
        black_list = self.data.pattern_black_list
        if link_type == WILDCARD:
            type_id = None
        else:
            if link_type in black_list:
                return []  # no pattern index for blacklisted types
            type_id = self._type_id(link_type)
            if type_id is None:
                return []
        unordered = link_type in UNORDERED_LINK_TYPES and link_type != WILDCARD
        grounded: List[Tuple[int, int]] = []
        for p, h in enumerate(target_handles):
            if h == WILDCARD:
                continue
            row = self._row_of(h)
            if row is None:
                return []
            grounded.append((p, row))
        if unordered:
            counts: Dict[int, int] = {}
            for _, row in grounded:
                counts[row] = counts.get(row, 0) + 1
            local = self.probe_unordered(arity, type_id, tuple(sorted(counts.items())))
        else:
            local = self.probe_ordered(arity, type_id, tuple(grounded))
        out = self._materialize(arity, local)
        if type_id is None and black_list:
            out = [(h, tg) for h, tg in out
                   if self.data.links[h].named_type not in black_list]
        return out

    def get_matched_type_template(self, template):
        template_hash = self._flatten_template_hash(self._hash_template(template))
        per_arity = self.probe_ctype(int(hex_to_i64(template_hash)))
        out = []
        for arity, local in sorted(per_arity.items()):
            out.extend(self._materialize(arity, local))
        return out

    def get_matched_type(self, link_type: str):
        type_id = self._type_id(link_type)
        if type_id is None:
            return []
        out = []
        for arity in sorted(self.dev.buckets):
            local = self.probe_ordered(arity, type_id, ())
            if local.size:
                out.extend(self._materialize(arity, local))
        return out


def _selected(local: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """The valid entries of a padded probe result, on the host (one fetch
    of both tensors)."""
    return local.cpu().numpy()[mask.cpu().numpy()]
