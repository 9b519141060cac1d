"""Kernels 2-4: sort-merge join, index join and anti join.

Replace `das_tpu/kernels/join.py` (`join_tables_impl`, `index_join_impl`,
`anti_join_impl`).  The CUDA kernels live in `csrc/join_tables.cu` (stable
grouping by key, no sort: csrc/group.cuh), `csrc/index_join.cu` (32-way
warp searches of the posting index and a block scan in one launch, or a
grid on the scan of `csrc/primitives.cu`) and `csrc/anti_join.cu` (a hash
set, no sort).  Their plain PyTorch versions are `das_tpu_torch/ops/join.py`'s
functions of the same names: taken for CPU tensors and held against the
kernels on the card."""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from das_tpu_torch.kernels import launch
from das_tpu_torch.ops import join as plain

join_tables_plain = plain.join_tables
index_join_plain = plain.index_join
anti_join_plain = plain.anti_join

def _check_table(vals, valid, name, dev):
    launch.check(vals, f"{name}_vals", torch.int32, 2, dev)
    launch.check(valid, f"{name}_valid", torch.bool, 1, dev)
    if valid.shape[0] != vals.shape[0]:
        raise ValueError(f"{name}: vals and valid differ in length")


def join_tables(left_vals, left_valid, right_vals, right_valid,
                pairs: Tuple[Tuple[int, int], ...], right_extra: Tuple[int, ...],
                capacity: int):
    """Equi-join of two binding tables (the sort-merge join of the
    reference; no sort here).  Returns (out_vals[capacity,
    kL+len(right_extra)] int32, out_valid bool, total int64 0-d); total is
    exact, even past capacity.  The C entry picks its regime from the
    shapes (csrc/join_tables.cu: `block`, one launch of one block, or
    `global`, the grouping engine's grid passes)."""
    t0 = launch.mark()
    if not launch.is_cuda(left_vals):
        return launch.noted("join_tables", t0, False, right_vals.shape, join_tables_plain(
            left_vals, left_valid, right_vals, right_valid, pairs, right_extra, capacity))
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    _check_table(right_vals, right_valid, "right", dev)
    (n_left, kl), (n_right, kr) = left_vals.shape, right_vals.shape
    pairs, right_extra = _as_tuples(pairs), tuple(right_extra)
    out, ov, tot = launch.carve(dev, (((capacity, kl + len(right_extra)), torch.int32),
                                      ((capacity,), torch.bool), ((), torch.int64)))
    lib = launch.library()
    scratch = launch.scratch(lib.das_join_tables_scratch(n_left, n_right, capacity), dev)
    n_launched, regime = launch.launches_out(), launch.regime_out()
    with launch.on_device(dev):
        err = lib.das_join_tables(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl,
            right_vals.data_ptr(), right_valid.data_ptr(), n_right, kr, *_pair_arrays(pairs),
            *_col_array(right_extra), capacity, launch.ptr(scratch), out.data_ptr(),
            ov.data_ptr(), tot.data_ptr(), n_launched, regime, launch.stream_of(dev))
    launch.raise_on(err, "join_tables")
    launch.count_call("join_tables", regime, n_launched)
    return launch.noted("join_tables", t0, True, right_vals.shape, (out, ov, tot))


def index_join(left_vals, left_valid, keys_sorted, perm, targets, type_key: int,
               pairs, right_var_cols, right_extra, capacity: int):
    """Join a binding table into a whole link type through its
    (type<<32|target) posting index (never materialized).  Returns
    (out_vals[capacity, kL+len(right_extra)] int32, out_valid bool,
    total int64 0-d); total is exact, even past capacity.  The C entry
    picks its regime from n_left and capacity (csrc/index_join.cu:
    `block`, one launch of one block, or `global`, a bounds grid, the
    device-wide scan and an expand grid)."""
    t0 = launch.mark()
    if not launch.is_cuda(left_vals):
        return launch.noted("index_join", t0, False, left_vals.shape, index_join_plain(
            left_vals, left_valid, keys_sorted, perm, targets, type_key, pairs,
            right_var_cols, right_extra, capacity))
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    launch.check(keys_sorted, "keys_sorted", torch.int64, 1, dev)
    launch.check(perm, "perm", torch.int32, 1, dev)
    launch.check(targets, "targets", torch.int32, 2, dev)
    if perm.shape[0] != keys_sorted.shape[0]:
        raise ValueError("perm and keys_sorted differ in length")
    (n_left, kl), (n_rows, arity) = left_vals.shape, targets.shape
    pairs, right_extra = _as_tuples(pairs), tuple(right_extra)
    out, ov, tot = launch.carve(dev, (((capacity, kl + len(right_extra)), torch.int32),
                                      ((capacity,), torch.bool), ((), torch.int64)))
    lib = launch.library()
    scratch = launch.scratch(lib.das_index_join_scratch(n_left, capacity), dev)
    n_launched, regime = launch.launches_out(), launch.regime_out()
    with launch.on_device(dev):
        err = lib.das_index_join(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl, pairs[0][0],
            int(type_key), keys_sorted.data_ptr(), keys_sorted.shape[0], perm.data_ptr(),
            targets.data_ptr(), n_rows, arity,
            *_index_arrays(pairs, tuple(right_var_cols), right_extra), capacity,
            launch.ptr(scratch), out.data_ptr(), ov.data_ptr(), tot.data_ptr(), n_launched,
            regime, launch.stream_of(dev))
    launch.raise_on(err, "index_join")
    launch.count_call("index_join", regime, n_launched)
    return launch.noted("index_join", t0, True, left_vals.shape, (out, ov, tot))


@functools.lru_cache(maxsize=1024)
def _pair_arrays(pairs):
    """(left columns, right columns, count) of the join pairs as C arrays,
    built once per pairs tuple (the C entries only read them)."""
    return (launch.int_array([a for a, _ in pairs]), launch.int_array([b for _, b in pairs]),
            len(pairs))


@functools.lru_cache(maxsize=1024)
def _col_array(cols):
    """(columns, count) as a C array, built once per columns tuple."""
    return launch.int_array(cols), len(cols)


@functools.lru_cache(maxsize=1024)
def _index_arrays(pairs, right_var_cols, right_extra):
    """(check left columns, check target positions, count, extra target
    positions, count) of an index join as C arrays, built once per shape:
    the pairs after the first, which the kernel checks, and right_extra,
    each right column mapped to its target position."""
    checks = pairs[1:]
    return (launch.int_array([lc for lc, _ in checks]),
            launch.int_array([right_var_cols[rc] for _, rc in checks]), len(checks),
            *_col_array(tuple(right_var_cols[rc] for rc in right_extra)))


def _as_tuples(pairs):
    return pairs if isinstance(pairs, tuple) else tuple(map(tuple, pairs))


def anti_join(left_vals, left_valid, right_vals, right_valid, pairs):
    """Negation filter: the left validity mask with every row whose mixed
    join key occurs among the valid right rows cleared (bool [L]).  The C
    entry picks its regime from n_right (csrc/anti_join.cu: `shared`, a set
    in each block's shared memory, or `global`, a set in device memory)."""
    t0 = launch.mark()
    if not launch.is_cuda(left_vals):
        return launch.noted("anti_join", t0, False, right_vals.shape, anti_join_plain(
            left_vals, left_valid, right_vals, right_valid, pairs))
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    _check_table(right_vals, right_valid, "right", dev)
    (n_left, kl), (n_right, kr) = left_vals.shape, right_vals.shape
    keep = launch.empty(n_left, torch.bool, dev)
    pairs = _as_tuples(pairs)
    lib = launch.library()
    table = launch.scratch(lib.das_anti_join_scratch(n_right), dev)
    n_launched, regime = launch.launches_out(), launch.regime_out()
    with launch.on_device(dev):
        err = lib.das_anti_join(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl,
            right_vals.data_ptr(), right_valid.data_ptr(), n_right, kr, *_pair_arrays(pairs),
            launch.ptr(table), keep.data_ptr(), n_launched, regime, launch.stream_of(dev))
    launch.raise_on(err, "anti_join")
    launch.count_call("anti_join", regime, n_launched)
    return launch.noted("anti_join", t0, True, right_vals.shape, keep)
