"""The k-way star join, as plain PyTorch: the plain version of kernel 5
(port of `das_tpu/kernels/multiway.py` multiway_join_impl, following
`_mw_prologue` and `_mw_window` step by step).

A star prefix — clause 0 plus T tail clauses that each share exactly one
variable v with it — is grounded in one pass, with no intermediate table:

  1. mix clause 0's v column and each tail's v column into 64-bit keys
     (the binary chain's `mix_columns`, sentinels included);
  2. stably argsort each tail's keys;
  3. per clause-0 row and tail, the lower bound and the count of its key
     in the sorted tail; the running product of the counts, and the
     partial totals sum_i prod_{t' <= t} cnt_t'(i) — totals[t] is the size
     the t-th binary intermediate would have had;
  4. offsets = inclusive scan of the final product;
  5. output slot j belongs to row li = upper_bound(offsets, j), and its
     offset inside that row's block decodes in mixed radix, LAST tail
     fastest — the left-deep chain's pair layout, position for position;
  6. each tail's row is verified exactly on v (the mix is only a route),
     and the row [clause 0 | each tail's extra columns] is emitted;
     invalid slots are 0.

Counts and sums are int64 with two's-complement wraparound, as XLA's."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from das_tpu_torch.ops.join import SENTINEL_L, SENTINEL_R, mix_columns
from das_tpu_torch.ops.posting import search


def _take(x, idx):
    """x[idx] for an index already clipped to [0, max(n-1, 0)]; an empty
    x reads as zeros (the reference cannot gather from a zero-row array;
    every such slot lies past the total and is zeroed anyway)."""
    if x.shape[0] == 0:
        return torch.zeros(idx.shape + x.shape[1:], dtype=x.dtype, device=x.device)
    return x[idx]


def multiway_join_plain(left_vals, left_valid, tails: Sequence[Tuple], vcol0: int,
                        tail_meta: Sequence[Tuple[int, Tuple[int, ...]]], capacity: int):
    """k-way star join.  `tails` is a sequence of (vals, mask) term tables,
    `tail_meta[t] = (v column, extra columns)`.  Returns
    (out_vals[capacity, k_out] int32, out_valid[capacity] bool,
    totals[T] int64), totals[t] the exact pair count of the t-th would-be
    binary intermediate (totals[-1] = the final join size)."""
    tail_meta = tuple((int(v), tuple(e)) for v, e in tail_meta)
    dev = left_vals.device
    n_left = left_vals.shape[0]
    key_l = mix_columns(left_vals, (vcol0,), left_valid, SENTINEL_L)
    prepared = []
    run = None
    partials = []
    for (tv, tm), (vcol, _extras) in zip(tails, tail_meta):
        key_t = mix_columns(tv, (vcol,), tm, SENTINEL_R)
        order = torch.argsort(key_t, stable=True).to(torch.int32)
        key_sorted = key_t[order.long()]
        lo = search(key_sorted, key_l, "left")
        hi = search(key_sorted, key_l, "right")
        cnt = hi - lo
        run = cnt if run is None else run * cnt
        partials.append(run.sum())
        prepared.append((tv, tm, order, lo, cnt))
    offsets = torch.cumsum(run, 0)
    total = partials[-1]

    j = torch.arange(capacity, dtype=torch.int64, device=dev)
    li = search(offsets, j, "right")
    li_safe = torch.clamp(li, 0, max(n_left - 1, 0))
    rem = j - _take(offsets - run, li_safe)
    ris = [None] * len(prepared)
    for t in range(len(prepared) - 1, -1, -1):
        tv, _tm, order, lo, cnt = prepared[t]
        c_safe = torch.clamp(_take(cnt, li_safe), min=1)
        o = torch.remainder(rem, c_safe)
        rem = torch.div(rem, c_safe, rounding_mode="floor")
        # int64 -> int32 wraps before the clip, as the reference's astype
        ri_sorted = (_take(lo, li_safe) + o).to(torch.int32)
        ri_sorted = torch.clamp(ri_sorted, 0, max(tv.shape[0] - 1, 0)).long()
        ris[t] = _take(order, ri_sorted).long()
    out_valid = (j < total) & _take(left_valid, li_safe)
    lvv = _take(left_vals[:, vcol0], li_safe)
    parts = [_take(left_vals, li_safe)]
    for t, (vcol, extras) in enumerate(tail_meta):
        tv, tm, _order, _lo, _cnt = prepared[t]
        rt = ris[t]
        out_valid = out_valid & _take(tm, rt) & (_take(tv[:, vcol], rt) == lvv)
        if extras:
            parts.append(_take(tv, rt)[:, list(extras)])
    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    out = torch.where(out_valid[:, None], out, 0).contiguous()
    return out, out_valid, torch.stack(partials)
