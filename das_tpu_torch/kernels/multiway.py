"""Kernel 5: the k-way star join.

Replaces `das_tpu/kernels/multiway.py` multiway_join_impl.  The CUDA kernel
lives in `csrc/multiway.cu` (on the mix, scan and radix sort of
`csrc/primitives.cu`); its plain PyTorch version is
`das_tpu_torch/ops/multiway.py` multiway_join_plain, taken for CPU tensors
and held against the kernel on the card."""

from __future__ import annotations

import torch

from das_tpu_torch.kernels import launch
from das_tpu_torch.kernels.join import _check_table
from das_tpu_torch.ops.multiway import multiway_join_plain

#: most columns of one table (csrc/common.cuh DAS_MAXC)
MAX_COLS = 16


def multiway_join(left_vals, left_valid, tails, vcol0: int, tail_meta, capacity: int):
    """k-way star join of a left table with T tail tables on one shared
    variable.  `tails` is a sequence of (vals, mask), `tail_meta[t] =
    (v column, extra columns)`.  Returns (out_vals[capacity, k_out] int32,
    out_valid bool, totals[T] int64) — totals[t] the exact size of the
    t-th would-be binary intermediate."""
    if not launch.is_cuda(left_vals):
        return multiway_join_plain(left_vals, left_valid, tails, vcol0, tail_meta, capacity)
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    n_tails = len(tails)
    if n_tails < 1 or len(tail_meta) != n_tails:
        raise ValueError("multiway_join takes at least one tail, each with its meta")
    tail_meta = tuple((int(v), tuple(int(c) for c in e)) for v, e in tail_meta)
    for t, (tv, tm) in enumerate(tails):
        _check_table(tv, tm, f"tail{t}", dev)
    n_left, kl = left_vals.shape
    if kl > MAX_COLS or any(len(e) > MAX_COLS for _v, e in tail_meta):
        raise ValueError(f"multiway_join takes at most {MAX_COLS} columns per table")
    rows = [tv.shape[0] for tv, _ in tails]
    k_out = kl + sum(len(e) for _v, e in tail_meta)
    extras = []
    for _v, e in tail_meta:
        extras += list(e) + [0] * (MAX_COLS - len(e))
    out = launch.empty((capacity, k_out), torch.int32, dev)
    ov = launch.empty(capacity, torch.bool, dev)
    tot = launch.empty(n_tails, torch.int64, dev)
    s = launch.sort_scratch(max(rows), n_left, dev)
    n_all = max(sum(rows), 1)
    key_r = launch.empty(n_all, torch.int64, dev)
    key_sorted = launch.empty(n_all, torch.int64, dev)
    order = launch.empty(n_all, torch.int32, dev)
    key_l = launch.empty(max(n_left, 1), torch.int64, dev)
    lo = launch.empty(max(n_tails * n_left, 1), torch.int64, dev)
    cnt = launch.empty(max(n_tails * n_left, 1), torch.int64, dev)
    run = launch.empty(max(n_left, 1), torch.int64, dev)
    offsets = launch.empty(max(n_left, 1), torch.int64, dev)
    lib = launch.library()
    tail_table = launch.empty(n_tails * lib.das_multiway_tail_bytes(), torch.uint8, dev)
    with torch.cuda.device(dev):
        err = lib.das_multiway_join(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl, int(vcol0), n_tails,
            launch.ptr_array([tv for tv, _ in tails]), launch.ptr_array([tm for _, tm in tails]),
            launch.int64_array(rows), launch.int_array([tv.shape[1] for tv, _ in tails]),
            launch.int_array([v for v, _e in tail_meta]),
            launch.int_array([len(e) for _v, e in tail_meta]), launch.int_array(extras),
            capacity, key_l.data_ptr(), key_r.data_ptr(), key_sorted.data_ptr(),
            order.data_ptr(), s["tmp_keys"].data_ptr(), s["tmp_idx"].data_ptr(),
            s["hist"].data_ptr(), s["hist_incl"].data_ptr(), lo.data_ptr(), cnt.data_ptr(),
            run.data_ptr(), offsets.data_ptr(), s["scan"].data_ptr(), s["scan_len"],
            tail_table.data_ptr(), out.data_ptr(), ov.data_ptr(), tot.data_ptr(), launch.stream_of(dev),
        )
    launch.raise_on(err, "multiway_join")
    launch.LAUNCH_COUNTS["multiway"] += 1
    return out, ov, tot
