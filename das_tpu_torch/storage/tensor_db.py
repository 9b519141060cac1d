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
dispatched before the commit still reads the tables it was planned on."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from das_tpu_torch.core.config import DasConfig
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
    """MemoryDB whose finalized columns also live on a torch device.  The
    DBInterface surface (get_matched_links and friends) is inherited from
    MemoryDB and answers on the host; compiled conjunctive queries run on
    the device tables through `.dev`.  `get_incoming` and the commit path
    come from IncrementalCommitMixin."""

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
            self.fin = self.data.finalize()
            self.dev = DeviceTables(self.fin, self.device)
            self._reset_delta_state()
            return
        self._apply_delta(*action)

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
