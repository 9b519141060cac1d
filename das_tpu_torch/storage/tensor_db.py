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

Incremental commits (delta merges into the capacity slack) are not
ported yet: `refresh()` re-finalizes and re-uploads the whole store."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.storage.atom_table import AtomSpaceData, Finalized, LinkBucket
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


def capacity_class(n: int) -> int:
    """Device-bucket capacity for n real rows: ~6% slack (min 64), the
    same deterministic class as the JAX store (storage/delta.py)."""
    return n + max(64, n >> 4)


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


class TensorDB(MemoryDB):
    """MemoryDB whose finalized columns also live on a torch device.  The
    DBInterface surface (get_matched_links and friends) is inherited from
    MemoryDB and answers on the host; compiled conjunctive queries run on
    the device tables through `.dev`."""

    def __init__(self, data: Optional[AtomSpaceData] = None,
                 config: Optional[DasConfig] = None, device=None):
        self.device = resolve_device(device)
        super().__init__(data)
        self.config = config or DasConfig()
        self.fin: Finalized = self.data.finalize()
        self.dev = DeviceTables(self.fin, self.device)
        #: bumped whenever the store is rebuilt: the planner's statistics
        #: and the count result cache hold for one generation
        self.generation = 0

    def __repr__(self):
        return "<TensorDB>"

    def refresh(self) -> None:
        """Re-sync the device store after host-side mutations: a full
        re-finalize and re-upload (the incremental delta merge is a later
        slice).  Replacing `.dev` drops the cached fused executor too."""
        self.prefetch()
        fin = self.data.finalize()
        if fin is self.fin:
            return
        self.fin = fin
        self.dev = DeviceTables(self.fin, self.device)
        self.generation += 1

    # -- low-level lookups (shared with the query compiler) ----------------

    def _type_id(self, link_type: str) -> Optional[int]:
        h = self.data.table.get_named_type_hash(link_type)
        return self.fin.type_id_of_hash.get(h)

    def _row_of(self, handle_hex: str) -> Optional[int]:
        return self.fin.row_of_hex.get(handle_hex)
