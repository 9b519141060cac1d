"""The least time of a kernel call, from its own arguments.

Frozen copy of `chip_smoke.py` `work_of` and `bytes_bound_ms` (the byte
and operation counts of the five kernels of `das_tpu_torch/kernels/`),
kept here so that the yardstick cannot move with the program.  A call's
least time is the larger of its bytes over the card's memory bandwidth
and its integer operations over the card's 32-bit rate; a kernel's share
of its roofline is the sum of its calls' least times over the device time
the profiler gave those calls.

Peaks: NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TOP/s of
32-bit operations outside the tensor cores, both at the full 700 W power
limit (the run prints the card's limit beside the share).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

#: wrapper attribute of `das_tpu_torch.kernels` per kernel (the executor
#: probes a plan's terms in one `probe_term_tables` call)
WRAPPERS = {
    "probe": "probe_term_tables", "index_join": "index_join", "join_tables": "join_tables",
    "anti_join": "anti_join", "multiway": "multiway_join",
}

#: name prefixes of the CUDA kernels of das_tpu_torch/kernels/csrc/ that each
#: wrapper's C entry launches (group.cuh's grouping engine serves both the
#: sort-merge and the multiway joins; primitives.cu's scan the index join)
KERNEL_PREFIXES = ("pr_", "ij_", "jt_", "aj_", "mw_", "grp_", "scan_tile_kernel",
                   "scan_add_kernel")


def least_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S)


def work_of(name, args, kw, out):
    """(bytes, operations) the call's data needs: every input it must read
    once, every output written once; a probe or index join reads only the
    posting-index window its keys select; a multiway join reads every
    mask, the v column of the valid rows, and the other columns only of
    the rows it emits."""

    def nb(t):
        return t.numel() * t.element_size()

    if name == "probe" and isinstance(out, list):
        works = [work_of("probe", tuple(t[:6]), {}, o) for t, o in zip(args[0], out)]
        return sum(w[0] for w in works), sum(w[1] for w in works)
    if name == "probe":
        ks, perm, targets, _key, _f, cap = args
        window = min(int(out[2]), cap)
        arity = targets.shape[1]
        steps = 2 * max(1, math.ceil(math.log2(max(ks.numel(), 2))))
        n_bytes = steps * ks.element_size() + window * 4 * (1 + arity) + nb(out[0]) + nb(out[1]) + 4
        return n_bytes, steps + window * (6 + arity)
    if name == "index_join":
        lv, lm, ks, perm, targets = args[:5]
        cap = args[-1]
        pairs_used = min(int(out[2]), cap)
        steps = 2 * max(1, math.ceil(math.log2(max(ks.numel(), 2))))
        arity = targets.shape[1]
        n_bytes = (nb(lv) + nb(lm) + lv.shape[0] * steps * 8
                   + pairs_used * 4 * (1 + arity) + nb(out[0]) + nb(out[1]) + 8)
        return n_bytes, lv.shape[0] * (steps + 4) + cap * (2 * steps + 8)
    if name == "join_tables":
        lv, lm, rv, rm = args[:4]
        cap = args[-1]
        n_r = max(rv.shape[0], 2)
        n_bytes = nb(lv) + nb(lm) + nb(rv) + nb(rm) + nb(out[0]) + nb(out[1]) + 8
        ops = (lv.shape[0] + rv.shape[0]) * 8 + 8 * rv.shape[0] * 12 \
            + lv.shape[0] * 4 * math.log2(n_r) + cap * (2 * math.log2(max(lv.shape[0], 2)) + 8)
        return n_bytes, ops
    if name == "multiway":
        lv, lm, tails, _vcol0, meta, cap = args
        n_l = int(lm.sum())
        n_out = int(out[1].sum())
        n_valid = [int(m.sum()) for _v, m in tails]
        n_bytes = nb(lm) + n_l * 4 + n_out * 4 * (lv.shape[1] - 1) \
            + sum(nb(m) + n * 4 + n_out * 4 * len(extra)
                  for (_v, m), n, (_c, extra) in zip(tails, n_valid, meta)) \
            + nb(out[0]) + nb(out[1]) + nb(out[2])
        ops = n_l * 8 + sum(
            n * (8 + 8 * 12) + n_l * 4 * math.log2(max(n, 2)) for n in n_valid
        ) + min(int(out[2][-1]), cap) * (2 * math.log2(max(n_l, 2)) + 8 * len(tails))
        return n_bytes, ops
    if name == "anti_join":
        lv, lm, rv, rm = args[:4]
        n_r = max(rv.shape[0], 2)
        n_bytes = nb(lv) + nb(lm) + nb(rv) + nb(rm) + nb(out)
        ops = (lv.shape[0] + rv.shape[0]) * 8 + 8 * rv.shape[0] * 12 \
            + lv.shape[0] * 4 * math.log2(n_r)
        return n_bytes, ops
    raise KeyError(name)
