"""Kernel 5: the k-way star join.

Replaces `das_tpu/kernels/multiway.py` multiway_join_impl.  The CUDA kernels
live in `csrc/multiway.cu`; its plain PyTorch version is
`das_tpu_torch/ops/multiway.py` multiway_join_plain, taken for CPU tensors
and held against the kernel on the card.

Three regimes, which the C entry picks from the shapes alone (never from
the data) and reports by name: `block` (one launch of one block, everything
in shared memory), `filter` (the tails filtered by the set of the left's
mixed keys and the survivors grouped stably, no sort, the set and the bin
histogram in shared memory) and `global` (the same launches with the set and
the histograms in device memory)."""

from __future__ import annotations

import functools

import torch

from das_tpu_torch.kernels import launch
from das_tpu_torch.kernels.join import _check_table
from das_tpu_torch.ops.multiway import multiway_join_plain

#: the C entry reads each tail's extra columns from a row of this many
MAX_COLS = launch.MAX_COLS


def multiway_join(left_vals, left_valid, tails, vcol0: int, tail_meta, capacity: int):
    """k-way star join of a left table with T tail tables on one shared
    variable.  `tails` is a sequence of (vals, mask), `tail_meta[t] =
    (v column, extra columns)`.  Returns (out_vals[capacity, k_out] int32,
    out_valid bool, totals[T] int64) — totals[t] the exact size of the
    t-th would-be binary intermediate."""
    t0 = launch.mark()
    if not launch.is_cuda(left_vals):
        return launch.noted("multiway", t0, False, left_vals.shape, multiway_join_plain(
            left_vals, left_valid, tails, vcol0, tail_meta, capacity))
    dev = left_vals.device
    n_tails = len(tails)
    if n_tails < 1 or len(tail_meta) != n_tails:
        raise ValueError("multiway_join takes at least one tail, each with its meta")
    _check_table(left_vals, left_valid, "left", dev)
    for t, (tv, tm) in enumerate(tails):
        _check_table(tv, tm, f"tail{t}", dev)
    tail_meta = tuple((int(v), tuple(int(c) for c in e)) for v, e in tail_meta)
    n_left, kl = left_vals.shape
    if kl > MAX_COLS or any(len(e) > MAX_COLS for _v, e in tail_meta):
        raise ValueError(f"multiway_join takes at most {MAX_COLS} columns per table")
    rows = [tv.shape[0] for tv, _ in tails]
    ks, vcols, n_extra, extras, n_extra_cols = _meta_arrays(
        tail_meta, tuple(tv.shape[1] for tv, _ in tails))
    k_out = kl + n_extra_cols
    out = launch.empty((capacity, k_out), torch.int32, dev)
    ov = launch.empty(capacity, torch.bool, dev)
    tot = launch.empty(n_tails, torch.int64, dev)
    rows_c = launch.int64_array(rows)
    args = (left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl, int(vcol0), n_tails,
            launch.ptr_array([tv for tv, _ in tails]), launch.ptr_array([tm for _, tm in tails]),
            rows_c, ks, vcols, n_extra, extras, capacity)
    lib = launch.library()
    scratch = launch.scratch(lib.das_multiway_scratch(n_left, n_tails, rows_c, capacity), dev)
    n_launched, regime = launch.launches_out(), launch.regime_out()
    with launch.on_device(dev):
        err = lib.das_multiway(*args, launch.ptr(scratch), out.data_ptr(), ov.data_ptr(),
                               tot.data_ptr(), n_launched, regime, launch.stream_of(dev))
    launch.raise_on(err, "multiway_join")
    launch.count_call("multiway", regime, n_launched)
    return launch.noted("multiway", t0, True, left_vals.shape, (out, ov, tot))


@functools.lru_cache(maxsize=1024)
def _meta_arrays(tail_meta, ks):
    """The C arrays of a star's static shape: each tail's width, v column,
    extra-column count and extra columns (padded to MAX_COLS), and the
    extra columns' total."""
    extras = []
    for _v, e in tail_meta:
        extras += list(e) + [0] * (MAX_COLS - len(e))
    return (launch.int_array(ks), launch.int_array([v for v, _e in tail_meta]),
            launch.int_array([len(e) for _v, e in tail_meta]), launch.int_array(extras),
            sum(len(e) for _v, e in tail_meta))
