"""Kernels 2-4: sort-merge join, index join and anti join.

Replace `das_tpu/kernels/join.py` (`join_tables_impl`, `index_join_impl`,
`anti_join_impl`).  The CUDA kernels live in `csrc/join_tables.cu`,
`csrc/index_join.cu` and `csrc/anti_join.cu` (on the shared mix, scan and
radix sort of `csrc/primitives.cu`).  Their plain PyTorch versions are
`das_tpu_torch/ops/join.py`'s functions of the same names: taken for CPU
tensors and held against the kernels on the card."""

from __future__ import annotations

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
    """Sort-merge equi-join of two binding tables.  Returns
    (out_vals[capacity, kL+len(right_extra)] int32, out_valid bool,
    total int64 0-d); total is exact, even past capacity."""
    if not launch.is_cuda(left_vals):
        return join_tables_plain(left_vals, left_valid, right_vals, right_valid,
                                 pairs, right_extra, capacity)
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    _check_table(right_vals, right_valid, "right", dev)
    (n_left, kl), (n_right, kr) = left_vals.shape, right_vals.shape
    k_out = kl + len(right_extra)
    out = launch.empty((capacity, k_out), torch.int32, dev)
    ov = launch.empty(capacity, torch.bool, dev)
    tot = launch.empty(1, torch.int64, dev)
    s = launch.sort_scratch(n_right, n_left, dev)
    key_l = launch.empty(max(n_left, 1), torch.int64, dev)
    lo = launch.empty(max(n_left, 1), torch.int64, dev)
    cnt = launch.empty(max(n_left, 1), torch.int64, dev)
    offsets = launch.empty(max(n_left, 1), torch.int64, dev)
    lib = launch.library()
    with torch.cuda.device(dev):
        err = lib.das_join_tables(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl,
            right_vals.data_ptr(), right_valid.data_ptr(), n_right, kr,
            launch.int_array([a for a, _ in pairs]), launch.int_array([b for _, b in pairs]),
            len(pairs), launch.int_array(right_extra), len(right_extra), capacity,
            key_l.data_ptr(), s["key_r"].data_ptr(), s["key_r_sorted"].data_ptr(),
            s["order"].data_ptr(), s["tmp_keys"].data_ptr(), s["tmp_idx"].data_ptr(),
            s["hist"].data_ptr(), s["hist_incl"].data_ptr(), lo.data_ptr(), cnt.data_ptr(),
            offsets.data_ptr(), s["scan"].data_ptr(), s["scan_len"],
            out.data_ptr(), ov.data_ptr(), tot.data_ptr(), launch.stream_of(dev),
        )
    launch.raise_on(err, "join_tables")
    launch.LAUNCH_COUNTS["join_tables"] += 1
    return out, ov, tot[0]


def index_join(left_vals, left_valid, keys_sorted, perm, targets, type_key: int,
               pairs, right_var_cols, right_extra, capacity: int):
    """Join a binding table into a whole link type through its
    (type<<32|target) posting index (never materialized).  Returns
    (out_vals[capacity, kL+len(right_extra)] int32, out_valid bool,
    total int64 0-d)."""
    if not launch.is_cuda(left_vals):
        return index_join_plain(left_vals, left_valid, keys_sorted, perm, targets,
                                type_key, pairs, right_var_cols, right_extra, capacity)
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    launch.check(keys_sorted, "keys_sorted", torch.int64, 1, dev)
    launch.check(perm, "perm", torch.int32, 1, dev)
    launch.check(targets, "targets", torch.int32, 2, dev)
    if perm.shape[0] != keys_sorted.shape[0]:
        raise ValueError("perm and keys_sorted differ in length")
    n_left, kl = left_vals.shape
    n_rows, arity = targets.shape
    k_out = kl + len(right_extra)
    checks = list(pairs[1:])
    out = launch.empty((capacity, k_out), torch.int32, dev)
    ov = launch.empty(capacity, torch.bool, dev)
    tot = launch.empty(1, torch.int64, dev)
    lo = launch.empty(max(n_left, 1), torch.int64, dev)
    cnt = launch.empty(max(n_left, 1), torch.int64, dev)
    offsets = launch.empty(max(n_left, 1), torch.int64, dev)
    scan_len = max(launch.scan_scratch(n_left), 1)
    scan = launch.empty(scan_len, torch.int64, dev)
    lib = launch.library()
    with torch.cuda.device(dev):
        err = lib.das_index_join(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl, pairs[0][0],
            int(type_key), keys_sorted.data_ptr(), keys_sorted.shape[0],
            perm.data_ptr(), targets.data_ptr(), n_rows, arity,
            launch.int_array([lc for lc, _ in checks]),
            launch.int_array([right_var_cols[rc] for _, rc in checks]), len(checks),
            launch.int_array([right_var_cols[rc] for rc in right_extra]), len(right_extra),
            capacity, lo.data_ptr(), cnt.data_ptr(), offsets.data_ptr(),
            scan.data_ptr(), scan_len, out.data_ptr(), ov.data_ptr(), tot.data_ptr(),
            launch.stream_of(dev),
        )
    launch.raise_on(err, "index_join")
    launch.LAUNCH_COUNTS["index_join"] += 1
    return out, ov, tot[0]


def anti_join(left_vals, left_valid, right_vals, right_valid, pairs):
    """Negation filter: the left validity mask with every row whose mixed
    join key occurs among the valid right rows cleared (bool [L])."""
    if not launch.is_cuda(left_vals):
        return anti_join_plain(left_vals, left_valid, right_vals, right_valid, pairs)
    dev = left_vals.device
    _check_table(left_vals, left_valid, "left", dev)
    _check_table(right_vals, right_valid, "right", dev)
    (n_left, kl), (n_right, kr) = left_vals.shape, right_vals.shape
    keep = launch.empty(n_left, torch.bool, dev)
    s = launch.sort_scratch(n_right, 0, dev)
    key_l = launch.empty(max(n_left, 1), torch.int64, dev)
    lib = launch.library()
    with torch.cuda.device(dev):
        err = lib.das_anti_join(
            left_vals.data_ptr(), left_valid.data_ptr(), n_left, kl,
            right_vals.data_ptr(), right_valid.data_ptr(), n_right, kr,
            launch.int_array([a for a, _ in pairs]), launch.int_array([b for _, b in pairs]),
            len(pairs), key_l.data_ptr(), s["key_r"].data_ptr(),
            s["key_r_sorted"].data_ptr(), s["order"].data_ptr(), s["tmp_keys"].data_ptr(),
            s["tmp_idx"].data_ptr(), s["hist"].data_ptr(), s["hist_incl"].data_ptr(),
            s["scan"].data_ptr(), s["scan_len"], keep.data_ptr(), launch.stream_of(dev),
        )
    launch.raise_on(err, "anti_join")
    launch.LAUNCH_COUNTS["anti_join"] += 1
    return keep
