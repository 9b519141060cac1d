"""Kernel 1: fused probe -> gather -> verify -> term-table build.

Replaces `das_tpu/kernels/probe.py` (`probe_term_table_impl`).  The CUDA
kernel lives in `csrc/probe.cu`: `probe_term_tables` probes every term of a
plan in one launch (one launch per 16 terms), and `probe_term_table` is its
one-term call.  `probe_term_table_plain` and `probe_term_tables_plain`
beside them are the same function as plain PyTorch (the lowered
range_probe -> verify_positions -> build_term_table chain), taken for CPU
tensors and held against the kernel on the card."""

from __future__ import annotations

import functools
import struct
from typing import List, NamedTuple, Sequence, Tuple

import torch

from das_tpu_torch.kernels import launch
from das_tpu_torch.ops.join import build_term_table
from das_tpu_torch.ops.posting import range_probe

MAX_COLS = launch.MAX_COLS

#: one term's descriptor words before its static part (csrc/probe.cu
#: pr_term): 12 pointers and sizes, then MAX_COLS fixed values
_DYNAMIC = struct.Struct(f"{12 + MAX_COLS}q")
_ZEROS = (0,) * MAX_COLS


class ProbeTerm(NamedTuple):
    """One term to probe: a sorted posting-key column (int32 key_type, or
    int64 type_pos / ctype keys, padded with its dtype max), perm (int32
    bucket-local rows in key order), targets (int32 [n_rows, arity]), the
    key, the values of the extra_fixed positions, the capacity and the
    term's static columns."""

    sorted_keys: torch.Tensor
    perm: torch.Tensor
    targets: torch.Tensor
    probe_key: int
    fixed_vals: Sequence[int]
    capacity: int
    var_cols: Tuple[int, ...]
    eq_pairs: Tuple[Tuple[int, int], ...]
    extra_fixed: Tuple[int, ...]


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


def probe_term_tables_plain(terms: Sequence[ProbeTerm]):
    return [probe_term_table_plain(t.sorted_keys, t.perm, t.targets, t.probe_key, t.fixed_vals,
                                   t.capacity, var_cols=t.var_cols, eq_pairs=t.eq_pairs,
                                   extra_fixed=t.extra_fixed)
            for t in terms]


@functools.lru_cache(maxsize=1024)
def _static_words(var_cols, eq_pairs, extra_fixed) -> bytes:
    """The descriptor words a term's shape fixes (k, n_fixed, n_eq, then
    MAX_COLS each of var_cols, fixed positions, eq_a and eq_b), packed once
    per shape."""
    if max(len(var_cols), len(eq_pairs), len(extra_fixed)) > MAX_COLS:
        raise ValueError(f"probe: at most {MAX_COLS} var_cols, eq_pairs and extra_fixed")

    def pad(xs):
        return [int(x) for x in xs] + [0] * (MAX_COLS - len(xs))

    words = [len(var_cols), len(extra_fixed), len(eq_pairs), *pad(var_cols), *pad(extra_fixed),
             *pad([a for a, _ in eq_pairs]), *pad([b for _, b in eq_pairs])]
    return struct.pack(f"{len(words)}q", *words)


@functools.lru_cache(maxsize=1024)
def _out_specs(shapes):
    """The carve specs of a call's outputs, per (capacity, k) of its terms:
    every term's vals, mask and count."""
    specs = []
    for cap, k in shapes:
        specs += [((cap, k), torch.int32), ((cap,), torch.bool), ((), torch.int32)]
    return tuple(specs)


def _check_term(t: ProbeTerm, dev) -> None:
    if t.sorted_keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sorted_keys: dtype {t.sorted_keys.dtype}, expected int32 or int64")
    launch.check(t.sorted_keys, "sorted_keys", t.sorted_keys.dtype, 1, dev)
    launch.check(t.perm, "perm", torch.int32, 1, dev)
    launch.check(t.targets, "targets", torch.int32, 2, dev)
    if t.perm.shape[0] != t.sorted_keys.shape[0]:
        raise ValueError("perm and sorted_keys differ in length")
    if len(t.fixed_vals) != len(t.extra_fixed):
        raise ValueError("one fixed value per extra_fixed position")


def probe_term_tables(terms: Sequence[ProbeTerm]) -> List[Tuple]:
    """Every term's candidate links as a binding table, in one launch.

    Returns, per term, (vals[capacity, len(var_cols)] int32, mask[capacity]
    bool, count int32 0-d): count is the exact range size, which may exceed
    capacity (the caller's retry signal).  The outputs of all terms are
    views of one allocation."""
    if not terms:
        return []
    t0 = launch.mark()
    if not launch.is_cuda(terms[0].sorted_keys):
        return launch.noted("probe", t0, False, (len(terms),), probe_term_tables_plain(terms))
    dev = terms[0].sorted_keys.device
    for t in terms:
        _check_term(t, dev)
    outs = launch.carve(dev, _out_specs(tuple((t.capacity, len(t.var_cols)) for t in terms)))
    desc = []
    for t, vals, mask, count in zip(terms, outs[0::3], outs[1::3], outs[2::3]):
        keys, targets, fixed = t.sorted_keys, t.targets, t.fixed_vals
        desc.append(_DYNAMIC.pack(
            keys.data_ptr(), keys.dtype == torch.int64, keys.shape[0], int(t.probe_key),
            t.perm.data_ptr(), targets.data_ptr(), targets.shape[0], targets.shape[1],
            t.capacity, vals.data_ptr(), mask.data_ptr(), count.data_ptr(),
            *map(int, fixed), *_ZEROS[len(fixed):]))
        desc.append(_static_words(t.var_cols, t.eq_pairs, t.extra_fixed))
    lib = launch.library()
    n_launched, regime = launch.launches_out(), launch.regime_out()
    with launch.on_device(dev):
        err = lib.das_probe_terms(len(terms), b"".join(desc), n_launched, regime,
                                  launch.stream_of(dev))
    launch.raise_on(err, "probe")
    launch.count_call("probe", regime, n_launched)
    return launch.noted("probe", t0, True, (len(terms),),
                        list(zip(outs[0::3], outs[1::3], outs[2::3])))


def probe_term_table(sorted_keys, perm, targets, probe_key: int,
                     fixed_vals: Sequence[int], capacity: int, *,
                     var_cols: Tuple[int, ...], eq_pairs: Tuple[Tuple[int, int], ...],
                     extra_fixed: Tuple[int, ...]):
    """One term's candidate links as a binding table: `probe_term_tables`
    of that one term.  Returns (vals[capacity, len(var_cols)] int32,
    mask[capacity] bool, count int32 0-d)."""
    return probe_term_tables([ProbeTerm(sorted_keys, perm, targets, probe_key, fixed_vals,
                                        capacity, var_cols, eq_pairs, extra_fixed)])[0]
