"""Sorted-index probe primitives, as plain PyTorch (port of
`das_tpu/ops/posting.py`).

A probe is a fixed-capacity range scan over a sorted posting-key column:
it returns a padded candidate vector, a validity mask and the *exact*
match count, so the host can detect capacity overflow and retry with a
doubled buffer.  These run on whatever device their tensors live on; the
hand-written CUDA probe (`das_tpu_torch/kernels/probe.py`) is held
against them."""

from __future__ import annotations

from typing import Tuple

import torch

INVALID_ROW = 2**31 - 1


def search(sorted_keys: torch.Tensor, queries, side: str) -> torch.Tensor:
    """`jnp.searchsorted` with an int64 result: side='left' is the lower
    bound, side='right' the upper bound.  `queries` is a tensor or one
    integer (passed as a scalar: no host-to-device copy).  An empty key
    column gives 0."""
    if not isinstance(queries, torch.Tensor):
        queries = int(queries)
    if sorted_keys.shape[0] == 0:
        shape = queries.shape if isinstance(queries, torch.Tensor) else ()
        return torch.zeros(shape, dtype=torch.int64, device=sorted_keys.device)
    return torch.searchsorted(sorted_keys, queries, right=(side == "right"))


def range_probe(sorted_keys, perm, probe_key, capacity: int):
    """Bucket-local rows whose sort key equals `probe_key`.
    Returns (local[capacity] int32, valid[capacity] bool, count int32)."""
    lo = search(sorted_keys, probe_key, "left")
    hi = search(sorted_keys, probe_key, "right")
    count = (hi - lo).to(torch.int32)
    offs = torch.arange(capacity, dtype=torch.int32, device=sorted_keys.device)
    valid = offs < count
    n = sorted_keys.shape[0]
    if n == 0:
        local = torch.full((capacity,), INVALID_ROW, dtype=torch.int32,
                           device=sorted_keys.device)
        return local, valid, count
    idx = torch.clamp(lo.to(torch.int32) + offs, 0, n - 1).long()
    local = torch.where(valid, perm[idx], INVALID_ROW)
    return local, valid, count


def verify_positions(targets, type_id, local, valid, probe_type: int,
                     fixed: Tuple[Tuple[int, int], ...]):
    """Keep candidates whose type matches `probe_type` (-1 skips the type
    check) and whose target columns equal each (position, row) pair."""
    safe = torch.clamp(local, 0, targets.shape[0] - 1).long()
    mask = valid
    if probe_type >= 0:
        mask = mask & (type_id[safe] == probe_type)
    for pos, val in fixed:
        mask = mask & (targets[safe, pos] == val)
    return mask


def dedup_sorted(local, valid):
    """Sort candidates by row id and invalidate duplicates.
    Returns (sorted_local, keep)."""
    key = torch.where(valid, local, INVALID_ROW)
    s = torch.sort(key, stable=True).values
    first = torch.ones_like(s, dtype=torch.bool)
    if s.shape[0] > 1:
        first[1:] = s[1:] != s[:-1]
    return s, first & (s != INVALID_ROW)
