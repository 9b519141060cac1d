"""Carry a device store across from the JAX package as numpy arrays.

`device_tables_from_numpy` takes the tables in the plain form that a host
copy of a `das_tpu` `TensorDB.dev` gives:

    {"node_type_id": ndarray, "incoming_offsets": ndarray,
     "incoming_links": ndarray,
     "buckets": {arity: {field: ndarray or [ndarray, ...],
                         "size": int (optional)}}}

with every bucket field already capacity-padded, and returns the port's
`DeviceTables` on `device`, array for array.  Both packages can then
query the very same tables."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from das_tpu_torch.storage.tensor_db import (
    BUCKET_LIST_PADS,
    BUCKET_PADS,
    DeviceBucket,
    DeviceTables,
    resolve_device,
)


def _put(x, device) -> torch.Tensor:
    # a copy: host copies of device arrays may be read-only buffers
    return torch.from_numpy(np.array(x, order="C", copy=True)).to(device)


def device_tables_from_numpy(tables: Dict, device=None) -> DeviceTables:
    device = resolve_device(device)
    out = DeviceTables(None, device)
    for name in ("node_type_id", "incoming_offsets", "incoming_links"):
        setattr(out, name, _put(tables[name], device))
    for arity, b in tables["buckets"].items():
        fields = {name: _put(b[name], device) for name, _ in BUCKET_PADS}
        for name, _ in BUCKET_LIST_PADS:
            fields[name] = [_put(x, device) for x in b[name]]
        rows = np.asarray(b["rows"])
        # real rows are global atom ids (>= 0); the capacity slack pads -1
        size = int(b["size"]) if "size" in b else int((rows >= 0).sum())
        out.buckets[int(arity)] = DeviceBucket(
            arity=int(arity), size=size, capacity=int(rows.shape[0]), **fields
        )
    return out
