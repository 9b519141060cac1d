"""Kernel 1: fused probe -> gather -> verify -> term-table build.

Replaces `das_tpu/kernels/probe.py` (`probe_term_table_impl`).  The CUDA
kernel lives in `csrc/probe.cu`; `probe_term_table_plain` beside it is
the same function as plain PyTorch (the lowered range_probe ->
verify_positions -> build_term_table chain), taken for CPU tensors and
held against the kernel on the card."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from das_tpu_torch.kernels import launch
from das_tpu_torch.ops.join import build_term_table
from das_tpu_torch.ops.posting import range_probe


def probe_term_table_plain(sorted_keys, perm, targets, probe_key: int,
                           fixed_vals: Sequence[int], capacity: int, *,
                           var_cols, eq_pairs, extra_fixed):
    local, valid, count = range_probe(sorted_keys, perm, int(probe_key), capacity)
    mask = valid
    if extra_fixed:
        safe = torch.clamp(local, 0, targets.shape[0] - 1).long()
        for i, pos in enumerate(extra_fixed):
            mask = mask & (targets[safe, pos] == int(fixed_vals[i]))
    vals, mask = build_term_table(targets, local, mask, var_cols, eq_pairs)
    return vals, mask, count


def probe_term_table(sorted_keys, perm, targets, probe_key: int,
                     fixed_vals: Sequence[int], capacity: int, *,
                     var_cols: Tuple[int, ...], eq_pairs: Tuple[Tuple[int, int], ...],
                     extra_fixed: Tuple[int, ...]):
    """One term's candidate links as a binding table.

    sorted_keys — a sorted posting-key column (int32 key_type, or int64
    type_pos / ctype keys), padded with its dtype max; perm — int32
    bucket-local rows in key order; targets — int32 [n_rows, arity].
    Returns (vals[capacity, len(var_cols)] int32, mask[capacity] bool,
    count int32 0-d): count is the exact range size, which may exceed
    capacity (the caller's retry signal)."""
    if not launch.is_cuda(sorted_keys):
        return probe_term_table_plain(
            sorted_keys, perm, targets, probe_key, fixed_vals, capacity,
            var_cols=var_cols, eq_pairs=eq_pairs, extra_fixed=extra_fixed,
        )
    dev = sorted_keys.device
    if sorted_keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sorted_keys: dtype {sorted_keys.dtype}, expected int32 or int64")
    launch.check(sorted_keys, "sorted_keys", sorted_keys.dtype, 1, dev)
    launch.check(perm, "perm", torch.int32, 1, dev)
    launch.check(targets, "targets", torch.int32, 2, dev)
    if perm.shape[0] != sorted_keys.shape[0]:
        raise ValueError("perm and sorted_keys differ in length")
    if len(fixed_vals) != len(extra_fixed):
        raise ValueError("one fixed value per extra_fixed position")
    n_rows, arity = targets.shape
    k = len(var_cols)
    vals = launch.empty((capacity, k), torch.int32, dev)
    mask = launch.empty(capacity, torch.bool, dev)
    count = launch.empty(1, torch.int32, dev)
    lo = launch.empty(1, torch.int64, dev)
    lib = launch.library()
    with torch.cuda.device(dev):
        err = lib.das_probe_term_table(
            sorted_keys.data_ptr(), int(sorted_keys.dtype == torch.int64),
            sorted_keys.shape[0], int(probe_key), perm.data_ptr(), targets.data_ptr(),
            n_rows, arity, capacity,
            launch.int_array(var_cols), k,
            launch.int_array(extra_fixed), launch.int_array(fixed_vals), len(extra_fixed),
            launch.int_array([a for a, _ in eq_pairs]),
            launch.int_array([b for _, b in eq_pairs]), len(eq_pairs),
            lo.data_ptr(), vals.data_ptr(), mask.data_ptr(), count.data_ptr(),
            launch.stream_of(dev),
        )
    launch.raise_on(err, "probe")
    launch.LAUNCH_COUNTS["probe"] += 1
    return vals, mask, count[0]
