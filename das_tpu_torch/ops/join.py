"""Binding-table joins, as plain PyTorch (port of `das_tpu/ops/join.py`).

A binding set is a padded int32 matrix — one row per candidate
assignment, one column per variable (values are global atom row ids) —
plus a validity mask.  Conjunction is a sort-merge equi-join:

  1. mix the shared columns of each side into a 64-bit key,
  2. stably argsort the right side and search the left keys into it,
  3. expand the [lo, hi) ranges positionally into a fixed-capacity pair
     vector (slot j belongs to left row upper_bound(offsets, j)),
  4. verify the shared columns exactly (the mix is only a route, never
     trusted) and gather the output columns; invalid slots are 0.

Every function is static-shape and reports the exact pair total so the
host can retry on capacity overflow.  These are the plain versions the
hand-written CUDA kernels (`das_tpu_torch/kernels/`) are held against,
and the route a CPU tensor takes."""

from __future__ import annotations

from typing import Tuple

import torch

from das_tpu_torch.ops.posting import search

#: golden-ratio multiplier 0x9E3779B97F4A7C15 as a signed int64
MIX_MULT = -7046029254386353131
SENTINEL_L = 2**63 - 1
SENTINEL_R = 2**63 - 2


def mix_columns(vals, cols: Tuple[int, ...], valid, sentinel: int):
    """64-bit mix of the selected int32 columns (two's-complement
    wraparound, arithmetic `>> 29`); invalid rows get a side-specific
    sentinel so they can never pair up."""
    acc = torch.zeros(vals.shape[0], dtype=torch.int64, device=vals.device)
    for c in cols:
        acc = acc * MIX_MULT + vals[:, c].to(torch.int64)
        acc = acc ^ (acc >> 29)
    return torch.where(valid, acc, sentinel)


def _empty_pairs(capacity: int, k_out: int, device):
    return (
        torch.zeros((capacity, k_out), dtype=torch.int32, device=device),
        torch.zeros(capacity, dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int64, device=device),
    )


def _expand(lo, cnt, capacity: int):
    """Slot -> (left row, right position) for slots [0, capacity): slot j
    belongs to left row li = upper_bound(offsets, j); its right position
    is lo[li] + (j - prev[li]).  Returns (j, total, li_safe, ri_sorted)."""
    offsets = torch.cumsum(cnt, 0)
    total = offsets[-1]
    j = torch.arange(capacity, dtype=torch.int64, device=cnt.device)
    li = torch.searchsorted(offsets, j, right=True)
    li_safe = torch.clamp(li, 0, cnt.shape[0] - 1)
    prev = (offsets - cnt)[li_safe]
    ri_sorted = lo[li_safe] + (j - prev)
    return j, total, li_safe, ri_sorted


def _emit(left_vals, li_safe, right_rows, right_cols, out_valid):
    parts = [left_vals[li_safe]]
    if right_cols:
        parts.append(right_rows[:, list(right_cols)])
    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    out = torch.where(out_valid[:, None], out, 0)
    return out.contiguous(), out_valid


def build_term_table(targets, local, mask, var_cols, eq_pairs):
    """Project probed candidate links into a binding table: one column per
    variable (first occurrence position); `eq_pairs` enforces same-variable
    repeated positions."""
    safe = torch.clamp(local, 0, targets.shape[0] - 1).long()
    rows = targets[safe]
    for p1, p2 in eq_pairs:
        mask = mask & (rows[:, p1] == rows[:, p2])
    vals = rows[:, list(var_cols)]
    vals = torch.where(mask[:, None], vals, 0)
    return vals.contiguous(), mask


def join_tables(left_vals, left_valid, right_vals, right_valid,
                pairs: Tuple[Tuple[int, int], ...],
                right_extra: Tuple[int, ...], capacity: int):
    """Equi-join two binding tables.

    pairs       — (left_col, right_col) equality constraints (shared vars)
    right_extra — right columns appended after all left columns
    Returns (out_vals[capacity, kL+len(right_extra)] int32, out_valid bool,
    total int64).  With no shared columns this is the cross product."""
    k_out = left_vals.shape[1] + len(right_extra)
    n_left, n_right = left_vals.shape[0], right_vals.shape[0]
    if n_left == 0 or n_right == 0:
        return _empty_pairs(capacity, k_out, left_vals.device)
    key_l = mix_columns(left_vals, tuple(lc for lc, _ in pairs), left_valid, SENTINEL_L)
    key_r = mix_columns(right_vals, tuple(rc for _, rc in pairs), right_valid, SENTINEL_R)
    # stable: the pair layout depends on the order of tied right keys
    order = torch.argsort(key_r, stable=True)
    key_r_sorted = key_r[order]
    lo = search(key_r_sorted, key_l, "left")
    hi = search(key_r_sorted, key_l, "right")
    j, total, li_safe, ri_sorted = _expand(lo, hi - lo, capacity)
    ri = order[torch.clamp(ri_sorted, 0, n_right - 1)]
    out_valid = j < total
    for lc, rc in pairs:
        out_valid = out_valid & (left_vals[li_safe, lc] == right_vals[ri, rc])
    out_valid = out_valid & left_valid[li_safe] & right_valid[ri]
    out, out_valid = _emit(left_vals, li_safe, right_vals[ri], right_extra, out_valid)
    return out, out_valid, total


def index_join(left_vals, left_valid, keys_sorted, perm, targets, type_key: int,
               pairs, right_var_cols, right_extra, capacity: int):
    """Join the left table INTO a whole-type term via the prebuilt
    (type<<32|target) positional posting index: the right side is every
    link of one type, never materialized and never sorted.  The first
    shared pair keys the search (exact: the packed key is injective); the
    remaining pairs verify against the gathered target columns."""
    k_out = left_vals.shape[1] + len(right_extra)
    n_left, n_keys = left_vals.shape[0], keys_sorted.shape[0]
    if n_left == 0 or n_keys == 0:
        return _empty_pairs(capacity, k_out, left_vals.device)
    lc0, _rc0 = pairs[0]
    probe = torch.where(
        left_valid,
        (int(type_key) << 32) | left_vals[:, lc0].to(torch.int64),
        -1,
    )
    lo = search(keys_sorted, probe, "left")
    hi = search(keys_sorted, probe, "right")
    cnt = torch.where(left_valid, hi - lo, torch.zeros_like(lo))
    j, total, li_safe, ri_sorted = _expand(lo, cnt, capacity)
    local = perm[torch.clamp(ri_sorted, 0, n_keys - 1)]
    row_t = targets[torch.clamp(local, 0, targets.shape[0] - 1).long()]
    out_valid = (j < total) & left_valid[li_safe]
    for lc, rc in pairs[1:]:
        out_valid = out_valid & (row_t[:, right_var_cols[rc]] == left_vals[li_safe, lc])
    out, out_valid = _emit(
        left_vals, li_safe, row_t, tuple(right_var_cols[rc] for rc in right_extra),
        out_valid,
    )
    return out, out_valid, total


def anti_join(left_vals, left_valid, right_vals, right_valid, pairs):
    """NOT-filtering: invalidate left rows whose shared-column projection
    matches any right row.  Matches on the 64-bit mix alone (a false
    exclusion needs a full 64-bit collision), exactly as the reference's
    compiled path does, so the mix must agree bit for bit."""
    key_l = mix_columns(left_vals, tuple(lc for lc, _ in pairs), left_valid, SENTINEL_L)
    key_r = mix_columns(right_vals, tuple(rc for _, rc in pairs), right_valid, SENTINEL_R)
    key_r_sorted = torch.sort(key_r).values
    found = search(key_r_sorted, key_l, "right") > search(key_r_sorted, key_l, "left")
    return left_valid & ~found


def dedup_table(vals, valid):
    """Invalidate duplicate rows (exact: a stable lexicographic sort over
    all columns, column 0 most significant, then a neighbour compare).
    Returns (vals_sorted, keep, count int32)."""
    big = torch.where(valid[:, None], vals, 2**31 - 1)
    order = torch.arange(big.shape[0], device=vals.device)
    for c in range(big.shape[1] - 1, -1, -1):
        order = order[torch.argsort(big[order, c], stable=True)]
    s = big[order]
    same_as_prev = torch.zeros(s.shape[0], dtype=torch.bool, device=vals.device)
    if s.shape[0] > 1:
        same_as_prev[1:] = (s[1:] == s[:-1]).all(dim=1)
    keep = ~same_as_prev & valid[order]
    return s, keep, keep.sum(dtype=torch.int32)
