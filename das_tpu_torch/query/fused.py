"""Fused execution of compiled conjunctive queries (port of
`das_tpu/query/fused.py`: the planned single-query path, the multiway step,
the exact reference-order program, the single-device serving pipeline with
its result cache, and batched counting).

The JAX package traces a whole plan — every probe, join, multiway step and
anti-join — into ONE jitted program.  Here the same plan runs as an eager
sequence of kernel launches on the current stream (`run_conj`).  Every
buffer is sized on the host before launch from static capacities, exactly
as the JAX program sizes them, and all exact counts the host needs land in
one stats vector

    [count, reseed, any_pos_empty, *term_ranges, *step_totals]

that comes back in ONE host fetch per retry round (`FETCH_COUNTS`).  On
overflow the capacities double and the plan re-runs.

A round's host copies are queued right behind its kernels, into pinned
buffers, with a CUDA event recorded after them (`stage_many`); its settle
waits on that event alone (`_Staged.wait`), never on the stream, so a
batch settled while a later batch's kernels run does not wait for them.
A settle fetch retries on `fault.fetch_retry()` (a retry re-issues the
copies into fresh buffers), and `fault.maybe_fail("settle_fetch")` marks
it as a seam; the dispatch halves hold no seam.

The cost-based planner (das_tpu_torch/planner/, `DasConfig.use_planner`)
fixes the join order and the capacity seed of every step; when it declines
or is off, the greedy `order_plans` and the blind seeds apply.  The planner
may fuse a star prefix into one k-way multiway step (kernels/multiway.py):
`join_caps[0]` is then its output buffer, and its partial totals decide the
reference's empty-accumulator reseed verdict without the intermediates
existing.  Two reference quirks are decided from the stats exactly as in
the JAX package: an empty positive term is a definitive empty answer, and
an accumulator that a join empties with positive terms remaining (the
reseed quirk) — or an empty answer under a reordered fold — flags the
result; the caller re-runs it on the exact reference-order program
(`execute_exact`, `run_exact`), whose reseed automaton answers it as the
reference does.

Every execution is an `_ExecJob` with two halves: `dispatch()` enqueues a
round at the current capacities without waiting for the card, and
`settle()` reads that round's fetched stats and either finishes or grows
the capacities for another round.  The serving path (`dispatch_many`,
`settle_many_iter`) dispatches a whole batch before paying ONE host fetch
per retry round for all of its jobs together; answered results are kept in
a `ResultCache` for the store's `delta_version`.

`count_batch` counts many queries per call: queries group by shape, each
group runs its lanes one after another on one stream (the eager
counterpart of `jax.vmap`, identical lanes computed once) with one host
fetch per retry round per group; entries the greedy order cannot decide
re-run on the exact reference-order program.

With the program ledger on (obs/proflog.py), every builder's call goes
through `proflog.instrument`, keyed by its signature's digest, with
`program_model_bytes` / `tree_model_bytes` (kernels/budget.py's modeled
bytes of the call) beside what the card allocated; the dispatch and
settle-fetch halves sit in `obs.annotation` scopes for torch.profiler.

Learned capacities also go to a `CapStore` file when
`DasConfig.cap_store_dir` is set, and `export_warm_state` /
`apply_warm_state` carry them, the count-only cache entries and the
planner's statistics across a snapshot and restore (storage/durable.py)."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from das_tpu_torch import fault, kernels, obs
from das_tpu_torch.obs import proflog
from das_tpu_torch.ops.join import dedup_table
from das_tpu_torch.ops.posting import search
from das_tpu_torch.storage.atom_table import host_probe_locals, host_segments

# probe index routes (static per term).  Every compiler.TermPlan pins
# either a link type (type_id) or a composite type (ctype), so these three
# routes are exhaustive.
ROUTE_CTYPE = "ctype"        # template probe: composite-type key
ROUTE_TYPE_POS = "type_pos"  # (type_id<<32|target) at first grounded position
ROUTE_TYPE = "type"          # type-only probe

#: host fetches of device results (one per retry round of a fused
#: execution, one per materialization without a prefetched copy)
FETCH_COUNTS = {"n": 0}

#: the closed set of scopes allowed to copy to the host or wait for the
#: card (daslint DL013): the outermost function, qualified by module stem
#: (package name for __init__ modules), mapped to the tally that counts
#: its transfers, or to None where no fetch tally counts them (reason
#: beside each).  Adding a transfer means adding it here, under review.
FETCH_SITES = {
    # the fetch helpers: one count per round (per attempt when retried)
    "fused.fetch_many": "FETCH_COUNTS",
    "fused.fetch": "FETCH_COUNTS",
    "fused.retried_fetch": "FETCH_COUNTS",
    # the copies fetch_many / retried_fetch queued, and counted
    "fused._Staged.wait": None,
    # the serving pipeline's one fetch per settle round
    "fused.settle_pending_iter": "FETCH_COUNTS",
    # the whole-tree retry loop: one fetch per tree round
    "fused.run_tree_job": "FETCH_COUNTS",
    # execute()'s and the exact program's settle fetches
    "fused.FusedExecutor.execute": "FETCH_COUNTS",
    "fused.FusedExecutor.execute_exact": "FETCH_COUNTS",
    # count_batch: one fetch per count group's round
    "fused.FusedExecutor._run_batch_group": "FETCH_COUNTS",
    # explain(execute=True) driving a real job to settle
    "planner._explain_plans": "FETCH_COUNTS",
    # star counts' device fold: one fetch per GROUP of lanes
    "starcount._device_count_group": "FETCHES",
    # materialization when no prefetched host copy exists: one fetch per
    # table or batch, never on the cache-hit path
    "compiler.materialize": "FETCH_COUNTS",
    "tree.materialize_tables": "FETCH_COUNTS",
    "tree._tree_entry": "FETCH_COUNTS",
    "sharded_db.ShardedDB.materialize": "FETCH_COUNTS",
    # the mesh's execute() settle fetch
    "fused_sharded.ShardedFusedExecutor.execute": "FETCH_COUNTS",
    # the getters' probe results (get_links, probe_ordered): das_tpu reads
    # them with np.asarray, counted by neither package
    "tensor_db._selected": None,
    # a mesh slab's host copy for a checkpoint, not a query's fetch
    "sharded_db.ShardedBucket.host": None,
    # gloo staging of a cross-process collective (COLLECTIVE_STATS times it)
    "mesh._across": None,
    # the program ledger's first-call measurement, only with the ledger on
    "proflog._InstrumentedProgram.__call__": None,
    # the profiler trace's clock marker, once when a profile starts on a card
    "torchprof._launch_marker": None,
    # numpy arrays on the host (ingest and restore), no card involved
    "atom_table.build_bucket": None,
    "delta.IncrementalCommitMixin._record_delta_incoming": None,
    "checkpoint._restore_indexes": None,
    "checkpoint.try_restore_sharded": None,
}

#: token capacity for index-joined terms — never materialized
INDEX_TERM_TOKEN_CAP = 16


@dataclass(frozen=True)
class FusedTermSig:
    """Shape-static description of one term (no grounded values)."""

    arity: int
    route: str
    p0: int                        # probe position for *_pos routes, else -1
    extra_fixed: Tuple[int, ...]   # verified positions beyond the probe key
    var_cols: Tuple[int, ...]
    eq_pairs: Tuple[Tuple[int, int], ...]
    var_names: Tuple[str, ...]
    negated: bool


@dataclass(frozen=True)
class FusedPlanSig:
    terms: Tuple[FusedTermSig, ...]
    term_caps: Tuple[int, ...]
    join_caps: Tuple[int, ...]
    #: per join: -1 = sort-merge against the materialized right table;
    #: else the posting-index position of an INDEX JOIN (the right side
    #: stays implicit: a whole-type term probed through key_type_pos[p])
    index_joins: Tuple[int, ...] = ()
    #: leading positives fused into ONE k-way multiway step (0 = pure
    #: chain); join_caps[0] is then the multiway output buffer and
    #: index_joins cover only the tail binary joins
    multiway: int = 0


@dataclass
class FusedResult:
    var_names: Tuple[str, ...]
    vals: Optional[torch.Tensor]     # [cap, k] int32 (device); None if count-only
    valid: Optional[torch.Tensor]    # [cap] bool (device)
    count: int
    reseed_needed: bool      # the exact reference-order program must answer
    host_vals: Optional[np.ndarray] = None   # fetched with the stats
    host_valid: Optional[np.ndarray] = None
    multiway: bool = False   # answered by a program with a multiway step
    stats: Optional[np.ndarray] = None   # the final round's stats vector
    rounds: int = 0          # retry rounds run (one host fetch each)


#: largest per-term candidate window the exact (reference-order) program
#: materializes; beyond it the entry stays undecided (None)
EXACT_TERM_CAP_LIMIT = 1 << 20

#: a count group whose largest term capacity passes this runs no lanes
#: (the single-query paths answer such whole-type terms)
LARGE_TERM_BATCH_LIMIT = 1 << 23


def _pow2_at_least(n: int, lo: int = 16) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def fold_join_meta(terms: Tuple[FusedTermSig, ...]):
    """Static join metadata for a positive-term fold: output name order,
    per-join (pairs, extra) column maps, and which negated terms filter
    (NO_COVERING rule: a tabu with variables outside the output never
    excludes)."""
    positives = [i for i, t in enumerate(terms) if not t.negated]
    negatives = [i for i, t in enumerate(terms) if t.negated]
    names: Tuple[str, ...] = ()
    join_meta = []
    for n, i in enumerate(positives):
        t = terms[i]
        if n == 0:
            names = t.var_names
            continue
        pairs = tuple(
            (names.index(v), t.var_names.index(v)) for v in names if v in t.var_names
        )
        extra = tuple(j for j, v in enumerate(t.var_names) if v not in names)
        join_meta.append((pairs, extra))
        names = names + tuple(v for v in t.var_names if v not in names)
    anti_meta = []
    for i in negatives:
        t = terms[i]
        if set(t.var_names) <= set(names):
            anti_meta.append(
                (i, tuple((names.index(v), t.var_names.index(v)) for v in t.var_names))
            )
    return positives, negatives, names, join_meta, anti_meta


def multiway_meta(join_meta, mw: int):
    """Static k-way step metadata for a multiway prefix of `mw` clauses:
    (per-tail (v column, extra columns), clause 0's v column).  Every
    prefix join shares exactly one variable, at the same accumulated
    column."""
    assert all(len(join_meta[j][0]) == 1 for j in range(mw - 1)), (
        "multiway prefix joins must share exactly one variable"
    )
    meta = tuple((join_meta[j][0][0][1], join_meta[j][1]) for j in range(mw - 1))
    return meta, join_meta[0][0][0][0]


def _kernel_stage_plans(sigs, term_shapes, term_caps, join_caps, index_joins, *,
                        n_shards: int = 1, exch_caps=None, multiway: int = 0):
    """kernels/budget.py's byte plan of every kernel stage of one plan, as
    `das_tpu` prices them (its `kernel_program_plan`): the probes of the
    materialized terms, each join with the right side the kernel holds
    (S x cap rows where the mesh gathers it, S x q on both sides of a
    hash-partitioned join, the gathered left of an index join), the
    multiway step and each anti join.  term_shapes[i] is (n_keys, n_rows)
    of term i's probe index arrays (per slab on the mesh)."""
    from das_tpu_torch.kernels import budget

    positives, _negatives, _names, join_meta, anti_meta = fold_join_meta(sigs)
    start = multiway if multiway else 1
    index_joins = (tuple(index_joins) if index_joins
                   else tuple([-1] * max(0, len(positives) - start)))
    index_right = {positives[start + t]: t for t, p in enumerate(index_joins) if p >= 0}
    plans = []
    for i, t in enumerate(sigs):
        if i in index_right:
            continue  # never materialized; priced at its join below
        n_keys, n_rows = term_shapes[i]
        plans.append(budget.probe_plan(n_keys, n_rows, t.arity, len(t.var_cols), term_caps[i]))
    width = len(sigs[positives[0]].var_cols) if positives else 0
    left_rows = term_caps[positives[0]] if positives else 0
    if multiway:
        tails = [positives[j] for j in range(1, multiway)]
        kpad = max(len(sigs[i].var_cols) for i in tails)
        k_out = width + sum(len(join_meta[j][1]) for j in range(multiway - 1))
        plans.append(budget.multiway_plan(
            left_rows, width, tuple((n_shards * term_caps[i], kpad) for i in tails),
            k_out, join_caps[0]))
        width = k_out
        left_rows = join_caps[0]
    for t, i in enumerate(positives[start:]):
        pairs, extra = join_meta[start - 1 + t]
        jc = join_caps[(1 if multiway else 0) + t]
        k_out = width + len(extra)
        if index_joins[t] >= 0:
            n_keys, n_rows = term_shapes[i]
            plans.append(budget.index_join_plan(n_shards * left_rows, width, n_keys, n_rows,
                                                sigs[i].arity, k_out, jc))
        else:
            q = exch_caps[(1 if multiway else 0) + t] if exch_caps else 0
            if q:
                l_rows, r_rows = n_shards * q, n_shards * q
            else:
                l_rows, r_rows = left_rows, n_shards * term_caps[i]
            plans.append(budget.join_plan(l_rows, width, r_rows, len(sigs[i].var_cols),
                                          len(pairs), k_out, jc))
        width = k_out
        left_rows = jc
    for i, _pairs in anti_meta:
        plans.append(budget.anti_join_plan(left_rows, width, n_shards * term_caps[i],
                                           len(sigs[i].var_cols)))
    return plans


def program_model_bytes(sig, bucket_arrays, *_rest) -> int:
    """The modeled peak kernel footprint of one plan: the largest stage's
    resident plus streamed bytes (stages run one after another), from the
    call's own bucket arrays (a mesh signature's arrays are per-slab lists,
    whose slab sizes are the kernel boundary).  The program ledger divides
    it by the bytes the card allocated.  0 for a signature with no join
    steps to price (the exact program)."""
    if not hasattr(sig, "index_joins"):
        return 0
    sharded = hasattr(sig, "exch_caps")
    shapes = tuple(((a[0][0] if sharded else a[0]).shape[0],
                    (a[2][0] if sharded else a[2]).shape[0]) for a in bucket_arrays)
    plans = _kernel_stage_plans(
        sig.terms, shapes, sig.term_caps, sig.join_caps, sig.index_joins,
        n_shards=getattr(sig, "n_shards", 1), exch_caps=getattr(sig, "exch_caps", None),
        multiway=getattr(sig, "multiway", 0))
    if not plans:
        return 0
    return max(p.resident_bytes + p.block_bytes for p in plans)


def tree_model_bytes(sig, *site_inputs) -> int:
    """program_model_bytes over every site of a tree job: the largest."""
    ssigs = sig.sites + ((sig.neg,) if sig.neg is not None else ())
    return max((program_model_bytes(ssig, inputs[0])
                for ssig, inputs in zip(ssigs, site_inputs)), default=0)


def plan_index_joins(sigs: Tuple[FusedTermSig, ...], start: int = 0):
    """Static per-join index-join eligibility: the right side must be an
    ordered whole-type probe (ROUTE_TYPE, no extra verification, no
    repeated variables), positive, and actually share a variable.
    `start` skips the first joins (a multiway prefix's internal joins,
    whose clauses are materialized term tables).  Returns (index_joins for
    joins start..P-2, right_terms: term index -> position in that tuple)."""
    positives, _neg, _names, join_meta, _anti = fold_join_meta(sigs)
    index_joins = []
    right_terms = {}
    for n in range(start, max(0, len(positives) - 1)):
        i = positives[n + 1]
        t = sigs[i]
        pairs, _extra = join_meta[n]
        if (t.route == ROUTE_TYPE and not t.negated and not t.eq_pairs
                and not t.extra_fixed and pairs):
            index_joins.append(t.var_cols[pairs[0][1]])
            right_terms[i] = n - start
        else:
            index_joins.append(-1)
    return tuple(index_joins), right_terms


def apply_index_joins(buckets, sigs, arrays, term_caps, start_join: int = 0):
    """Decide per-join index-join routing and rewrite the affected terms'
    inputs: the positional posting index instead of the type-sorted window,
    and a token capacity (the term is never materialized).  `start_join`
    excludes a multiway prefix's internal joins."""
    index_joins, index_right = plan_index_joins(sigs, start_join)
    if index_right:
        arrays, term_caps = list(arrays), list(term_caps)
        for i, n in index_right.items():
            p = index_joins[n]
            b = buckets[sigs[i].arity]
            arrays[i] = (b.key_type_pos[p], b.order_by_type_pos[p], b.targets, b.type_id)
            term_caps[i] = INDEX_TERM_TOKEN_CAP
        arrays, term_caps = tuple(arrays), tuple(term_caps)
    return index_joins, frozenset(index_right), arrays, term_caps


def clamp_index_terms(term_caps, index_right):
    """Learned capacities may predate index-join routing for a signature;
    index-joined terms never materialize, so their token capacity must
    survive the merge."""
    return tuple(
        INDEX_TERM_TOKEN_CAP if i in index_right else c for i, c in enumerate(term_caps)
    )


def trivial_plan_count(db, plans) -> Optional[int]:
    """Exact count for a single positive term with distinct variables —
    entirely host-side, zero device work (every row in the term's key range
    yields one distinct assignment, links being content-addressed).  The
    grounded shape verifies the remaining fixed positions on the host
    copies of the same sorted indexes; a dangling (-1) target in a
    variable position leaves the count to the device (None)."""
    if plans is None or len(plans) != 1:
        return None
    p = plans[0]
    if p.negated or p.eq_pairs:
        return None
    if not p.fixed:
        return estimate_plan_rows(db, p)
    if p.ctype is not None or p.type_id is None:
        return None
    dangling = db.fin.dangling_hexes
    scan_dangling = dangling is None or len(dangling) > 0
    total = 0
    for b in host_segments(db, p.arity):
        local = host_probe_locals(b, p.type_id, p.fixed)
        if local.size == 0:
            continue
        if scan_dangling and p.var_cols and b.has_dangling:
            sub = b.targets[np.ix_(local, p.var_cols)]
            if (sub < 0).any():
                return None
        total += int(local.size)
    return total


def estimate_plan_rows(db, plan) -> int:
    """EXACT candidate count for one term with zero device work: binary
    searches of the host copies of the sorted key arrays the device
    probes."""
    total = 0
    for b in host_segments(db, plan.arity):
        if plan.ctype is not None:
            keys, key = b.key_ctype, np.int64(plan.ctype)
        elif plan.type_id is not None and plan.fixed:
            p0, v0 = plan.fixed[0]
            keys, key = b.key_type_pos[p0], (np.int64(plan.type_id) << 32) | np.int64(v0)
        else:
            keys, key = b.key_type, np.int32(plan.type_id)
        lo = int(np.searchsorted(keys, key, side="left"))
        hi = int(np.searchsorted(keys, key, side="right"))
        total += hi - lo
    return total


def reference_order_authoritative(positives) -> bool:
    """The positive terms are CONNECTED in reference order (every term
    shares a variable with the terms before it) AND at least one is
    grounded.  The fused fold is then the reference fold itself and its
    reseed flag is authoritative."""
    if len(positives) <= 1:
        return True
    bound = set(positives[0].var_names)
    for p in positives[1:]:
        if not (set(p.var_names) & bound):
            return False
        bound |= set(p.var_names)
    return any(p.fixed and p.ctype is None for p in positives)


def order_plans(plans, estimate) -> List:
    """Join ordering: the reference order when it is authoritative, else
    greedy smallest-first among terms connected to what is bound so far.
    Negated terms filter at the end regardless of order."""
    pos = [(p, estimate(p)) for p in plans if not p.negated]
    neg = [p for p in plans if p.negated]
    if len(pos) <= 1:
        return [p for p, _ in pos] + neg
    if reference_order_authoritative([p for p, _ in pos]):
        return [p for p, _ in pos] + neg
    ordered = []
    bound = set()
    remaining = list(pos)
    while remaining:
        connected = [
            (p, e) for p, e in remaining if not bound or (set(p.var_names) & bound)
        ] or remaining
        pick = min(connected, key=lambda pe: pe[1])
        remaining.remove(pick)
        ordered.append(pick[0])
        bound |= set(pick[0].var_names)
    return ordered + neg


def same_positive_order(ordered, plans) -> bool:
    """Reseed semantics depend only on the POSITIVE term order."""
    po = [p for p in ordered if not p.negated]
    pp = [p for p in plans if not p.negated]
    return len(po) == len(pp) and all(a is b for a, b in zip(po, pp))


def _scalar(x) -> torch.Tensor:
    return x.to(torch.int64).reshape(())


def probe_terms(sig, bucket_arrays, keys, fixed_vals, which):
    """The term tables (vals, mask, range count) of the terms `which` of a
    plan, probed in ONE call (one launch on the card): no probe depends on
    another."""
    terms = []
    for i in which:
        t = sig.terms[i]
        sorted_keys, perm, targets, _tid = bucket_arrays[i]
        terms.append(kernels.ProbeTerm(sorted_keys, perm, targets, keys[i], fixed_vals[i],
                                       sig.term_caps[i], t.var_cols, t.eq_pairs,
                                       t.extra_fixed))
    return kernels.probe_term_tables(terms)


def run_conj(sig: FusedPlanSig, bucket_arrays, keys, fixed_vals):
    """Run ONE conjunction — every probe, join and anti-join — as eager
    launches on the current stream.  Returns (acc_vals, acc_valid, stats)
    with stats the int64 device vector [count, reseed, any_pos_empty,
    *term_ranges, *join_totals]; nothing here waits for the device."""
    positives, _negatives, _names, join_meta, anti_meta = fold_join_meta(sig.terms)
    mw = sig.multiway
    # first positive the binary fold starts from (the accumulator is the
    # multiway output when mw, else the first term table)
    start = mw if mw else 1
    index_joins = sig.index_joins or tuple([-1] * max(0, len(positives) - start))
    index_right = {positives[start + t]: t for t, p in enumerate(index_joins) if p >= 0}
    dev = bucket_arrays[0][0].device
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    tables = {}
    term_ranges = []
    pos_count = {}
    probed = [i for i in range(len(sig.terms)) if i not in index_right]
    # no per-term dedup: every route pins the link type, so distinct
    # candidate links always yield distinct variable tuples
    tables.update(zip(probed, probe_terms(sig, bucket_arrays, keys, fixed_vals, probed)))
    for i in range(len(sig.terms)):
        if i in index_right:
            # index-join right side: never materialized; its candidate
            # count (for the empty-positive-term rule) is the type's range
            # in the (type<<32|target) index
            keys_sorted = bucket_arrays[i][0]
            tid = int(keys[i])
            pos_count[i] = (search(keys_sorted, (tid + 1) << 32, "left")
                            - search(keys_sorted, tid << 32, "left"))
            tables[i] = None
            term_ranges.append(zero)
            continue
        vals, mask, rng = tables[i]
        tables[i] = (vals, mask)
        pos_count[i] = mask.sum()
        term_ranges.append(_scalar(rng))

    # a positive term with zero verified candidates fails the whole And —
    # a DEFINITIVE empty answer, distinct from the reseed quirk
    any_pos_empty = torch.zeros((), dtype=torch.bool, device=dev)
    for i in positives:
        any_pos_empty = any_pos_empty | (pos_count[i] == 0)

    acc_vals, acc_valid = tables[positives[0]]
    join_counts = []
    if len(positives) > 1:
        reseed = acc_valid.sum() == 0
    else:
        reseed = torch.zeros((), dtype=torch.bool, device=dev)
    if mw:
        # k-way multiway step: every prefix clause grounds in one pass into
        # one output buffer (join_caps[0]).  Its partial totals are the
        # would-be binary intermediates' exact sizes, so the reseed verdict
        # follows the chain's rule: the t-th internal join counts iff it
        # comes before the program's LAST join (n < len(positives) - 2).
        mw_meta, mw_vcol0 = multiway_meta(join_meta, mw)
        acc_vals, acc_valid, mw_totals = kernels.multiway_join(
            acc_vals, acc_valid, [tables[i] for i in positives[1:mw]],
            mw_vcol0, mw_meta, sig.join_caps[0],
        )
        join_counts.append(mw_totals[mw - 2])
        for t in range(max(0, min(mw - 1, len(positives) - 2))):
            reseed = reseed | (mw_totals[t] == 0)
    for t, i in enumerate(positives[start:]):
        n = start - 1 + t          # absolute join position
        pairs, extra = join_meta[n]
        jc = sig.join_caps[(1 if mw else 0) + t]
        # no post-join dedup: a join of duplicate-free tables is
        # duplicate-free
        if index_joins[t] >= 0:
            ks, perm, targets, _tid = bucket_arrays[i]
            acc_vals, acc_valid, total = kernels.index_join(
                acc_vals, acc_valid, ks, perm, targets, keys[i],
                pairs, sig.terms[i].var_cols, extra, jc,
            )
        else:
            rv, rm = tables[i]
            acc_vals, acc_valid, total = kernels.join_tables(
                acc_vals, acc_valid, rv, rm, pairs, extra, jc,
            )
        join_counts.append(_scalar(total))
        if n < len(positives) - 2:
            reseed = reseed | (acc_valid.sum() == 0)

    for i, pairs in anti_meta:
        rv, rm = tables[i]
        acc_valid = kernels.anti_join(acc_vals, acc_valid, rv, rm, pairs)

    count = acc_valid.sum()
    reseed = reseed & ~any_pos_empty
    stats = torch.stack([
        _scalar(count), _scalar(reseed), _scalar(any_pos_empty),
        *term_ranges, *join_counts,
    ])
    return acc_vals, acc_valid, stats


@dataclass(frozen=True)
class FusedExactSig:
    """Shape-static description of a REFERENCE-ORDER plan for the exact
    program.  chain_caps holds one capacity per suffix chain join (s, i),
    s < i, in _chain_order() order."""

    terms: Tuple[FusedTermSig, ...]
    term_caps: Tuple[int, ...]
    chain_caps: Tuple[int, ...]


def _chain_order(P: int):
    return [(s, i) for s in range(P) for i in range(s + 1, P)]


def _fold_names(var_names_seq):
    """Static fold of output variable names along a join chain: the final
    name tuple and per-step (pairs, extra) join metadata."""
    names: Tuple[str, ...] = ()
    metas = []
    for n, vn in enumerate(var_names_seq):
        if n == 0:
            names = tuple(vn)
            continue
        pairs = tuple((names.index(v), vn.index(v)) for v in names if v in vn)
        extra = tuple(j for j, v in enumerate(vn) if v not in names)
        metas.append((pairs, extra))
        names = names + tuple(v for v in vn if v not in names)
    return names, metas


def exact_layout(sig: FusedExactSig):
    """Static output layout of the exact program: the full-K name order
    `all_names` (first appearance over the positives), each final state's
    bound names (`names_per_state[s]`, those of the suffix chain
    J(s, P-1)) and their columns in the full-K table (`cols_per_state`),
    and the capacity every state's table is padded to."""
    positives = [i for i, t in enumerate(sig.terms) if not t.negated]
    P = len(positives)
    cap_of = dict(zip(_chain_order(P), sig.chain_caps))
    all_names, _ = _fold_names([sig.terms[i].var_names for i in positives])
    names_per_state = tuple(
        _fold_names([sig.terms[positives[i]].var_names for i in range(s, P)])[0]
        for s in range(P)
    )
    cols_per_state = tuple(
        tuple(all_names.index(n) for n in names) for names in names_per_state
    )
    cap_final = max(
        cap_of[(s, P - 1)] if s < P - 1 else sig.term_caps[positives[s]] for s in range(P)
    )
    return all_names, names_per_state, cols_per_state, cap_final


def run_exact(sig: FusedExactSig, bucket_arrays, keys, fixed_vals, count_only: bool = False):
    """The reference And fold EXACTLY, reseed quirk included (the eager
    form of the JAX package's build_fused_exact).  Every possible reseed
    point s gives a static suffix chain J(s, i) = A_s join ... join A_i;
    all P(P-1)/2 chain joins run, the reference fold runs as a small
    automaton over their exact counts (state = latest reseed point), and
    the active state's count is reported.  Chain totals are masked to the
    active path so the host never grows capacity for chains never taken.
    The int64 device stats vector is
    [count, s_active, any_pos_empty, *term_ranges, *masked_chain_totals];
    with count_only it is all that returns.  Otherwise the result is
    (vals [cap_final, K], valid, stats): every state's final table
    projected onto the full-K layout of `exact_layout` and padded, the
    active state's selected on the device."""
    positives = [i for i, t in enumerate(sig.terms) if not t.negated]
    negatives = [i for i, t in enumerate(sig.terms) if t.negated]
    P = len(positives)
    cap_of = dict(zip(_chain_order(P), sig.chain_caps))
    all_names, final_names, cols_per_state, cap_final = exact_layout(sig)
    dev = bucket_arrays[0][0].device
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    chain_meta: Dict[Tuple[int, int], Tuple] = {}
    for s in range(P):
        _names, metas = _fold_names([sig.terms[positives[i]].var_names for i in range(s, P)])
        for off, meta in enumerate(metas):
            chain_meta[(s, s + 1 + off)] = meta

    tables = {}
    term_ranges = []
    probed = probe_terms(sig, bucket_arrays, keys, fixed_vals, range(len(sig.terms)))
    for i, (vals, mask, rng) in enumerate(probed):
        tables[i] = (vals, mask)
        term_ranges.append(_scalar(rng))
    pos_counts = [_scalar(tables[i][1].sum()) for i in positives]
    any_pos_empty = torch.zeros((), dtype=torch.bool, device=dev)
    for c in pos_counts:
        any_pos_empty = any_pos_empty | (c == 0)

    chain = {}
    counts = {}          # (s, i) -> exact rows of chain J(s, i)
    for s in range(P):
        chain[(s, s)] = tables[positives[s]]
        counts[(s, s)] = pos_counts[s]
        for i in range(s + 1, P):
            rv, rm = tables[positives[i]]
            pairs, extra = chain_meta[(s, i)]
            v, m, tot = kernels.join_tables(
                chain[(s, i - 1)][0], chain[(s, i - 1)][1], rv, rm, pairs, extra,
                cap_of[(s, i)],
            )
            chain[(s, i)] = (v, m)
            counts[(s, i)] = _scalar(tot)

    def active(values):
        """The value of the active state s_act, selected on the device."""
        return sum(torch.where(s_act == s, v, zero) for s, v in values.items())

    # the reference fold as an automaton over the chain counts: state =
    # latest reseed point, the transition taken BEFORE joining term i
    s_act = zero
    used = {}
    for i in range(1, P):
        prev_empty = active({s: counts[(s, i - 1)] for s in range(i)}) == 0
        for s in range(i):
            used[(s, i)] = (~prev_empty) & (s_act == s)
        s_act = torch.where(prev_empty, torch.full_like(s_act, i), s_act)
    masked_totals = [torch.where(used[p], counts[p], zero) for p in _chain_order(P)]

    final_counts = {}
    final_tables = {}
    for s in range(P):
        v, m = chain[(s, P - 1)]
        names_s = final_names[s]
        for ni in negatives:
            t = sig.terms[ni]
            if set(t.var_names) <= set(names_s):
                pairs = tuple((names_s.index(x), t.var_names.index(x)) for x in t.var_names)
                rv, rm = tables[ni]
                m = kernels.anti_join(v, m, rv, rm, pairs)
        final_counts[s] = _scalar(m.sum())
        final_tables[s] = (v, m)
    count = torch.where(any_pos_empty, zero, active(final_counts))
    stats = torch.stack([count, s_act, _scalar(any_pos_empty), *term_ranges, *masked_totals])
    if count_only:
        return stats

    # each state's final table projected onto the full-K layout, padded to
    # cap_final, the active one selected on the device
    K = len(all_names)
    final_vals = torch.zeros((cap_final, K), dtype=torch.int32, device=dev)
    final_valid = torch.zeros(cap_final, dtype=torch.bool, device=dev)
    for s in range(P):
        v, m = final_tables[s]
        proj = torch.zeros((cap_final, K), dtype=torch.int32, device=dev)
        proj[: v.shape[0], list(cols_per_state[s])] = v
        pm = torch.zeros(cap_final, dtype=torch.bool, device=dev)
        pm[: m.shape[0]] = m
        sel = s_act == s
        final_vals = torch.where(sel, proj, final_vals)
        final_valid = torch.where(sel, pm, final_valid)
    return final_vals, final_valid & ~any_pos_empty, stats


class _Staged:
    """The host copies of one round's output tensors (a sequence of tensor
    tuples, e.g. the outputs of a batch's dispatched jobs): on the card,
    non-blocking copies into pinned buffers queued right behind the
    kernels that write the tensors, and the CUDA event recorded after
    them; on the CPU, the tensors themselves."""

    __slots__ = ("groups", "pinned", "events")

    def __init__(self, groups, pinned, events):
        self.groups = groups
        self.pinned = pinned
        self.events = events

    def wait(self) -> List[List[np.ndarray]]:
        """The host arrays group by group, once this round's copies have
        landed: waits on the round's own events, not on the streams, so
        work queued after the copies is not waited for."""
        if self.events is None:
            host = [t.numpy() for g in self.groups for t in g]
        else:
            for event in self.events:
                event.synchronize()
            host = [h.numpy() for h in self.pinned]
        out, k = [], 0
        for g in self.groups:
            out.append(host[k:k + len(g)])
            k += len(g)
        return out


def stage_many(groups) -> _Staged:
    """Queue the host copies of every tensor of `groups` without waiting
    (see `_Staged`).  Called right after the kernels of a round, before
    anything else is queued, so the round's event follows its own work
    only."""
    flat_in = [t for g in groups for t in g]
    if not flat_in or flat_in[0].device.type != "cuda":
        return _Staged(groups, None, None)
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in flat_in]
    for h, t in zip(pinned, flat_in):
        h.copy_(t, non_blocking=True)
    # one event per card the tensors live on (a mesh's slabs may span cards)
    events = []
    for dev in dict.fromkeys(t.device for t in flat_in):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    return _Staged(groups, pinned, events)


def fetch_many(groups) -> List[List[np.ndarray]]:
    """ONE host fetch of every tensor of `groups`: the copies are queued
    into pinned memory without blocking, then their event is waited on
    once.  Returns the host arrays group by group."""
    FETCH_COUNTS["n"] += 1
    return stage_many(groups).wait()


def fetch(*tensors) -> List[np.ndarray]:
    """ONE host fetch of device tensors (`fetch_many` of one group)."""
    return fetch_many([tensors])[0]


def retried_fetch(staged: _Staged) -> List[List[np.ndarray]]:
    """A settle fetch of a staged round through `fault.fetch_retry()`:
    every attempt counts one host fetch, and a retry re-issues the copies
    into fresh pinned buffers instead of reading the ones it gave up on."""
    box = [staged]

    def attempt():
        FETCH_COUNTS["n"] += 1
        fault.maybe_fail("settle_fetch")
        if box[0] is None:
            box[0] = stage_many(staged.groups)
        return box[0].wait()

    def restage(_attempt, _exc):
        box[0] = None

    return fault.fetch_retry().run(attempt, on_retry=restage)


def _numel(vals) -> int:
    """Elements of a table: one tensor, or a sharded table's per-shard
    list."""
    if isinstance(vals, (list, tuple)):
        return sum(t.numel() for t in vals)
    return vals.numel()


class ResultCache:
    """Answered results of an executor, valid for one
    `delta_version` of the store (storage/delta.py: every commit and every
    rebuild bumps it).

    The key is (per-term plan tuple, count_only): the TermPlan tuple
    carries the plan's shape and every grounded value, and global rows are
    stable within a version, so a hit is the cached `FusedResult`
    (device tensors and the host copies fetched with them) with no device
    work and no host fetch.  A version change clears the cache and
    counts one invalidation (obs/ records each hit, miss and
    invalidation as a `cache.*` event and counter).  Entries are LRU-bounded by
    `config.result_cache_size` (0 disables the cache); reseed-flagged
    results are never cached, nor a table wider than `MAX_ENTRY_ROWS`
    elements, which would pin that much device and host memory."""

    #: widest binding table (rows x columns) one entry may pin
    MAX_ENTRY_ROWS = 1 << 20

    def __init__(self, db):
        self.db = db
        self._data: "OrderedDict" = OrderedDict()
        self._version = None
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "invalidations": 0}

    @staticmethod
    def key(plans, count_only: bool):
        return (
            tuple(
                (p.arity, p.type_id, p.ctype, p.fixed, p.var_names, p.var_cols, p.eq_pairs,
                 p.negated)
                for p in plans
            ),
            count_only,
        )

    def limit(self) -> int:
        return int(getattr(self.db.config, "result_cache_size", 0))

    def version(self):
        return getattr(self.db, "delta_version", None)

    def _sync_version(self) -> None:
        """Caller holds the lock."""
        v = self.version()
        if v != self._version:
            if self._data:
                self.stats["invalidations"] += 1
                if obs.enabled():
                    obs.event("cache.invalidate", entries=len(self._data), version=v)
                    obs.counter("cache.invalidations").inc()
            self._data.clear()
            self._version = v

    def get(self, key) -> Optional[FusedResult]:
        if self.limit() <= 0:
            return None
        with self._lock:
            self._sync_version()
            hit = self._data.get(key)
            if hit is None:
                self.stats["misses"] += 1
                if obs.enabled():
                    obs.event("cache.miss")
                    obs.counter("cache.misses").inc()
                return None
            self._data.move_to_end(key)
            self.stats["hits"] += 1
            if obs.enabled():
                obs.event("cache.hit", count=getattr(hit, "count", None))
                obs.counter("cache.hits").inc()
            return hit

    def put(self, key, result, version) -> None:
        """`version` is the delta_version the caller DISPATCHED against: a
        store committed to between dispatch and settle must not get a
        result of the old store cached under the new version.  A failed
        insert (the `cache_insert` seam) leaves the result uncached; the
        query does not see it."""
        from das_tpu_torch.core.exceptions import InjectedFault

        try:
            fault.maybe_fail("cache_insert")
        except InjectedFault:
            return
        limit = self.limit()
        if limit <= 0 or result is None or getattr(result, "reseed_needed", False):
            return
        vals = getattr(result, "vals", None)
        if vals is not None and _numel(vals) > self.MAX_ENTRY_ROWS:
            return
        with self._lock:
            self._sync_version()
            if version != self._version:
                return
            self._data[key] = result
            self._data.move_to_end(key)
            while len(self._data) > limit:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


class CapStore:
    """Learned capacities that outlive the process, keyed by a stable hash
    of the plan signature and a salt (the store's size).  The executor's
    `_caps` / `_exact_caps` dicts are the in-process record; a store holds
    the hashed entries read from its file or from a warm bundle, and
    `view` hashes the executor's dict only when a bundle is exported.
    With a directory, each learned capacity is also written to the file,
    so a fresh process starts at the last learned capacities instead of
    re-learning them through retry rounds.  Capacities are hints: a stale
    entry costs a retry, never an answer."""

    def __init__(self, tag: str, directory: Optional[str] = None):
        self.path = None if directory is None else os.path.join(directory, f"caps_{tag}.json")
        self._data = {}
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as fh:
                    self._data = json.load(fh)
            except Exception:  # noqa: BLE001 — an unreadable file is an empty store
                self._data = {}

    def __len__(self) -> int:
        return len(self._data)

    @staticmethod
    def _key(sigs, salt: str) -> str:
        return hashlib.md5((repr(sigs) + "|" + salt).encode()).hexdigest()

    def load(self, sigs, salt: str = ""):
        caps = self._data.get(self._key(sigs, salt))
        return None if caps is None else tuple(tuple(c) for c in caps)

    def save(self, sigs, caps, salt: str = "") -> None:
        """Write one learned capacity through to the store's file (a no-op
        without a directory)."""
        if self.path is None:
            return
        key = self._key(sigs, salt)
        as_lists = [list(c) for c in caps]
        if self._data.get(key) == as_lists:
            return
        self._data[key] = as_lists
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + f".tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(self._data, fh)
            os.replace(tmp, self.path)
        except Exception:  # noqa: BLE001 — persistence is best-effort
            pass

    def view(self, mem, salt: str) -> Dict:
        """The hashed entries with the executor's learned `mem` dict keyed
        in at the store's current salt."""
        out = dict(self._data)
        for sigs, caps in mem.items():
            out[self._key(sigs, salt)] = [list(c) for c in caps]
        return out


def result_cache_stats(db) -> Dict[str, int]:
    """Hit, miss and invalidation counters of the store's live executor
    caches, the conjunctive results' and the tree's, summed (zeros when no
    executor exists yet)."""
    out = {"hits": 0, "misses": 0, "invalidations": 0}
    ex = executor_of(db, create=False)
    if ex is not None:
        for cache in (ex.results, ex.tree_results):
            for k in out:
                out[k] += cache.stats[k]
    return out


def _grown(counts, caps) -> Tuple[int, ...]:
    """Capacities after one round: each one its exact count's power of two
    where the count overflowed it."""
    return tuple(_pow2_at_least(int(n)) if int(n) > c else c for n, c in zip(counts, caps))


class _ExecJob:
    """One execution's mutable state — ordered term arguments, the
    planner's program and the capacities, which grow between retry rounds
    — split into two halves so that a batch can dispatch every job before
    paying one host fetch for all of them: `dispatch()` enqueues a round,
    `settle()` reads its fetched stats."""

    def __init__(self, ex, count_only, same_order, sigs, arrays, keys, fvals, term_caps,
                 join_caps, index_joins, planned=None, multiway=0):
        self.ex = ex
        self.count_only = count_only
        self.same_order = same_order
        self.sigs = sigs
        self.arrays = arrays
        self.keys = keys
        self.fvals = fvals
        self.term_caps = term_caps
        self.join_caps = join_caps
        self.index_joins = index_joins
        #: the PlannedProgram that ordered and seeded this job (None = greedy)
        self.planned = planned
        #: leading positives fused into one multiway step (0 = binary chain)
        self.multiway = multiway
        self.rounds = 0
        self.last_ranges = None      # final round's exact per-term ranges
        self.last_join_rows = None   # final round's exact per-step totals
        self.names = fold_join_meta(sigs)[2]
        #: set by the settle that finishes the job; None at the ceiling
        self.result: Optional[FusedResult] = None
        #: per-answer route telemetry at settle; a tree job's site jobs are
        #: silent (the tree job counts its one fused_tree answer)
        self.count_route = True

    def plan_sig(self) -> FusedPlanSig:
        return FusedPlanSig(self.sigs, self.term_caps, self.join_caps, self.index_joins,
                            self.multiway)

    def dispatch(self) -> Tuple[torch.Tensor, ...]:
        """Enqueue one round at the current capacities.  Nothing here
        waits for the card.  Returns the tensors the host needs:
        (stats,) for a count, else (stats, vals, valid)."""
        from das_tpu_torch.planner import PLANNER_COUNTS

        self.rounds += 1
        if self.planned is not None:
            PLANNER_COUNTS["programs"] += 1
        sp = obs.NOOP_SPAN
        if obs.enabled():
            obs.counter("exec.dispatches").inc()
            sp = obs.span(
                "exec.dispatch", route="fused_multiway" if self.multiway else "fused",
                round=self.rounds, count_only=self.count_only,
                est_join_rows=(list(self.planned.est_join_rows)
                               if self.planned is not None else None),
            )
        sig = self.plan_sig()
        run = run_conj
        if proflog.enabled():
            run = proflog.instrument("fused", proflog.sig_digest(sig, self.count_only), run_conj,
                                     model_bytes=partial(program_model_bytes, sig, self.arrays))
        with sp, obs.annotation("exec.dispatch"):
            vals, valid, stats = run(sig, self.arrays, self.keys, self.fvals)
        return (stats,) if self.count_only else (stats, vals, valid)

    def settle(self, host_out, dev_out) -> bool:
        """Consume one round's fetched outputs (`host_out`, the host copies
        of `dev_out`).  True = finished: `result` is set, or None when the
        grown capacities would pass max_result_capacity (the staged path
        then answers and owns the overflow policy).  False = the
        capacities grew; dispatch again."""
        from das_tpu_torch.planner import observe_settle
        from das_tpu_torch.query.compiler import ROUTE_COUNTS

        stats = host_out[0]
        if self.count_only:
            vals = valid = host_vals = host_valid = None
        else:
            host_vals, host_valid = host_out[1], host_out[2]
            vals, valid = dev_out[1], dev_out[2]
        ranges = stats[3:3 + len(self.sigs)]
        jcounts = stats[3 + len(self.sigs):]
        new_tc = _grown(ranges, self.term_caps)
        new_jc = _grown(jcounts, self.join_caps)
        if new_tc != self.term_caps or new_jc != self.join_caps:
            if max(new_tc + new_jc, default=0) > self.ex.db.config.max_result_capacity:
                return True
            self.term_caps, self.join_caps = new_tc, new_jc
            return False
        self.ex._remember_caps(self.sigs, self.term_caps, self.join_caps)
        self.last_ranges = [int(r) for r in ranges]
        self.last_join_rows = [int(t) for t in jcounts]
        if self.planned is not None:
            observe_settle(self.planned, self.last_join_rows, self.rounds)
        count, reseed, pos_empty = int(stats[0]), bool(stats[1]), bool(stats[2])
        n_positive = sum(1 for s in self.sigs if not s.negated)
        self.result = FusedResult(
            var_names=self.names, vals=vals, valid=valid, count=count,
            # an empty result under a REORDERED fold could mask the
            # reseed quirk of the reference order: the exact program
            # redoes it; an empty POSITIVE TERM is always definitive
            reseed_needed=reseed or (
                count == 0 and n_positive > 1 and not pos_empty and not self.same_order
            ),
            host_vals=host_vals, host_valid=host_valid, multiway=bool(self.multiway),
            stats=stats, rounds=self.rounds,
        )
        if self.multiway and self.count_route:
            ROUTE_COUNTS["fused_multiway"] += 1
        return True


class _PendingMany:
    """One dispatched-but-unsettled batch: cache-prefilled results, the
    in-flight jobs with their index lists and cache keys, the tensors of
    the enqueued round and their queued host copies, and the delta_version the batch was dispatched
    against (it guards the settle-time cache inserts)."""

    __slots__ = ("results", "jobs", "outs", "staged", "version", "fetch_ms")

    def __init__(self, results, jobs, outs, version):
        self.results = results
        self.jobs = jobs
        self.outs = outs
        #: the round's host copies, queued right behind its kernels
        self.staged = stage_many(outs)
        self.version = version
        #: wall ms of each settle round's host fetch; empty when no fetch
        #: happened (all hits, all declined)
        self.fetch_ms: List[float] = []


def dispatch_pending(results_cache, exec_job, plans_lists, count_only, cache_only=False):
    """First half of the serving pipeline: dedup identical queries of the
    batch, answer cache hits, and enqueue the first round of every other
    job — nothing waits for the card.  `exec_job(plans, count_only)`
    returns a dispatchable job or None (a dispatch-time decline).  The
    dedup comes BEFORE the cache lookup, so a duplicate shares its
    original's job (or hit) and records no miss of its own.  With
    cache_only nothing is dispatched: a miss stays a decline."""
    results: List = [None] * len(plans_lists)
    version = results_cache.version()
    jobs = []
    by_key: Dict[Tuple, List[int]] = {}
    for i, plans in enumerate(plans_lists):
        key = results_cache.key(plans, count_only)
        dup = by_key.get(key)
        if dup is not None:
            dup.append(i)
            continue
        hit = results_cache.get(key)
        if hit is not None:
            results[i] = hit
            continue
        if cache_only:
            continue
        job = exec_job(plans, count_only)
        if job is not None:
            idxs = [i]
            by_key[key] = idxs
            jobs.append((idxs, job, key))
    outs = [job.dispatch() for _, job, _ in jobs]
    return _PendingMany(results, jobs, outs, version)


def settle_pending_iter(results_cache, pending):
    """Streaming second half: yields `(index, result)` as each answer
    becomes final — cache hits first, then, per retry round, every job
    whose verdict landed in that round's ONE host fetch (a ceiling yields
    None).  The fetch waits on the round's own event (`_Staged`) and
    retries on `fault.fetch_retry()`, each attempt counted.  Jobs whose
    capacities grew re-dispatch here, inside the iterator, their copies
    queued right behind them.  Settle-time cache inserts are guarded by
    the dispatch-time delta_version.  Indices declined at dispatch are
    never yielded (their `pending.results` entry stays None)."""
    for i, hit in enumerate(pending.results):
        if hit is not None:
            yield i, hit
    jobs, outs, staged = pending.jobs, pending.outs, pending.staged
    while jobs:
        t0 = time.perf_counter()
        with obs.annotation("exec.settle_fetch"):
            fetched = retried_fetch(staged)
        fetch_s = time.perf_counter() - t0
        pending.fetch_ms.append(fetch_s * 1e3)
        if obs.enabled():
            obs.counter("exec.fetches").inc()
            obs.histogram("exec.settle_fetch_ms").observe(fetch_s * 1e3)
            obs.REC.record("exec.settle_fetch", "X", t0, fetch_s, 0, {"jobs": len(jobs)})
        nxt = []
        for (idxs, job, key), host, out in zip(jobs, fetched, outs):
            if job.settle(host, out):
                results_cache.put(key, job.result, pending.version)
                for i in idxs:
                    pending.results[i] = job.result
                    yield i, job.result
            else:
                nxt.append((idxs, job, key))
        jobs = nxt
        outs = [job.dispatch() for _, job, _ in jobs]
        staged = stage_many(outs)
    pending.jobs, pending.outs, pending.staged = [], [], None


def settle_pending(results_cache, pending) -> List:
    """Drive a _PendingMany to the end (the list form of
    settle_pending_iter).  Returns every entry's result (None = declined
    at dispatch or at the ceiling)."""
    for _ in settle_pending_iter(results_cache, pending):
        pass
    return pending.results


# ---- whole-tree fusion: one tree job for an Or/negation tree ------------------


def conj_stats_len(n_terms: int, n_steps: int) -> int:
    """Length of one conjunction's stats block inside a whole-tree stats
    vector: [count, reseed, any_pos_empty, *term_ranges, *join_counts]."""
    return 3 + n_terms + n_steps


def canonical_tree_names(terms) -> Tuple[str, ...]:
    """Canonical output layout of a whole-tree job: the site's bound
    variables in SORTED name order — the column order the staged tree's
    union projects to (query/tree.py _canonicalize), so dedup and anti-join
    row equality match the host assignment-set identity exactly."""
    return tuple(sorted(fold_join_meta(terms)[2]))


@dataclass(frozen=True)
class FusedTreeSig:
    """Shape-static description of ONE whole-tree job: every positive Or
    branch as a full per-site plan signature, plus the joint negative
    conjunction of the de-Morgan difference branch.  The nested
    FusedPlanSigs carry the per-site capacities and routing, so the tree
    signature changes whenever one of them does."""

    sites: Tuple[FusedPlanSig, ...]
    neg: Optional[FusedPlanSig] = None


def _take_cols(vals: torch.Tensor, cols: Tuple[int, ...]) -> torch.Tensor:
    """`vals[:, cols]` as device ops only (no index tensor is copied from
    the host, which would wait for the stream)."""
    if tuple(cols) == tuple(range(vals.shape[1])):
        return vals
    return torch.stack([vals[:, c] for c in cols], dim=1)


def build_fused_tree(sig: FusedTreeSig):
    """The whole Or/negation plan tree as ONE function of eager launches
    (the JAX package's one jitted program): every conjunction site runs
    `run_conj`, the positive branches are projected onto the canonical
    sorted-name columns and concatenated, then either deduplicated (the
    union) or, with a negative branch, the joint negative table is
    anti-joined against the raw concat on ALL columns (the de-Morgan
    difference; duplicates in a membership set are harmless).  Nothing
    here waits for the card.

    Returns (fn, names).  fn(*site_inputs) takes one (bucket_arrays, keys,
    fixed_vals) triple per positive site, then one for the negative site
    when sig.neg is set, and returns (vals, valid, stats), where stats is
    the int64 vector
      [final_count, *site_0_block, ..., *neg_block]
    with each block [count, reseed, any_pos_empty, *term_ranges,
    *join_counts] (conj_stats_len per site)."""
    out_names = canonical_tree_names(sig.sites[0].terms)
    K = len(out_names)
    perms = []
    for ssig in sig.sites + ((sig.neg,) if sig.neg is not None else ()):
        names = fold_join_meta(ssig.terms)[2]
        assert tuple(sorted(names)) == out_names, (
            "tree fusion requires one shared variable universe"
        )
        perms.append(tuple(names.index(v) for v in out_names))

    def fn(*site_inputs):
        blocks = []
        parts = []
        for i, ssig in enumerate(sig.sites):
            ba, ks, fv = site_inputs[i]
            v, m, sl = run_conj(ssig, ba, ks, fv)
            blocks.append(sl)
            parts.append((_take_cols(v, perms[i]), m))
        union_vals = torch.cat([v for v, _ in parts], dim=0)
        union_valid = torch.cat([m for _, m in parts], dim=0)
        if sig.neg is not None:
            ba, ks, fv = site_inputs[len(sig.sites)]
            nv, nm, nsl = run_conj(sig.neg, ba, ks, fv)
            blocks.append(nsl)
            nv = _take_cols(nv, perms[-1])
            all_pairs = tuple((c, c) for c in range(K))
            nm = kernels.anti_join(nv, nm, union_vals, union_valid, all_pairs)
            out_vals, out_valid = nv, nm
            count = nm.sum()
        else:
            # exact union dedup: every site is an ordered table over one
            # variable set, so positional row equality over the canonical
            # columns IS the reference assignment identity
            out_vals, out_valid, count = dedup_table(union_vals, union_valid)
        stats = torch.cat([_scalar(count).reshape(1), *blocks])
        return out_vals, out_valid, stats

    return fn, out_names


class _TreeExecJob:
    """One whole-tree execution's mutable state, split into the
    dispatch/settle halves like _ExecJob.  It wraps one count-only site
    _ExecJob per conjunction site: the site jobs own ordering, planner
    seeds, capacities and the reseed verdict (their settle halves read
    this job's per-site stats blocks), while THIS job owns the single tree
    function — one dispatch and one host fetch a round, where the staged
    tree pays one per site.

    Decline: a site at the capacity ceiling, or any site's reseed verdict,
    abandons the tree job (result None) and the staged tree answers, with
    the same answers."""

    __slots__ = ("ex", "site_jobs", "neg_job", "names", "rounds", "result",
                 "matched_any", "_done")

    #: the answer route counted at settle (ROUTE_KEYS)
    route = "fused_tree"

    def __init__(self, ex, site_jobs, neg_job):
        self.ex = ex
        self.site_jobs = site_jobs
        self.neg_job = neg_job
        self.names = None
        self.rounds = 0
        self.result = None
        #: the reference Or.matched verdict: any POSITIVE site matched
        #: (site count > 0), whatever the difference branch leaves
        self.matched_any = False
        self._done = set()

    def _all_jobs(self):
        return self.site_jobs + ([self.neg_job] if self.neg_job is not None else [])

    def tree_sig(self) -> FusedTreeSig:
        return FusedTreeSig(
            tuple(j.plan_sig() for j in self.site_jobs),
            self.neg_job.plan_sig() if self.neg_job is not None else None,
        )

    # -- the executor's hooks (the sharded job overrides them) --------------

    def _build(self, tree_sig):
        fn, names = build_fused_tree(tree_sig)
        return proflog.instrument("fused_tree", proflog.sig_digest(tree_sig, False), fn,
                                  model_bytes=partial(tree_model_bytes, tree_sig)), names

    def _flatten(self, out) -> Tuple[torch.Tensor, ...]:
        """The tree function's (vals, valid, stats) as the tensors to fetch."""
        return out

    def _unpack(self, flat, host: bool):
        """(vals, valid, stats) of `_flatten`'s tuple or its host copies."""
        return flat

    def _blk_len(self, j) -> int:
        return conj_stats_len(len(j.sigs), len(j.join_caps))

    def _make_result(self, vals, valid, count, host_vals, host_valid, stats):
        return FusedResult(var_names=self.names, vals=vals, valid=valid, count=count,
                           reseed_needed=False, host_vals=host_vals, host_valid=host_valid,
                           stats=stats, rounds=self.rounds)

    def dispatch(self) -> Tuple[torch.Tensor, ...]:
        """Enqueue the whole tree at every site's current capacities.
        Nothing here waits for the card.  Returns the tensors to fetch
        (`_flatten` of vals, valid, stats)."""
        from das_tpu_torch.planner import PLANNER_COUNTS

        tree_sig = self.tree_sig()
        cache = self.ex._tree_progs
        entry = cache.get(tree_sig)
        if entry is None:
            entry = self._build(tree_sig)
            if len(cache) > 64:
                cache.clear()  # one entry per capacity rung: keep it bounded
            cache[tree_sig] = entry
        fn, self.names = entry
        self.rounds += 1
        for j in self._all_jobs():
            j.rounds += 1
        if any(j.planned is not None for j in self._all_jobs()):
            # ONE job carried every planned site this round
            PLANNER_COUNTS["programs"] += 1
        sp = obs.NOOP_SPAN
        if obs.enabled():
            obs.counter("exec.dispatches").inc()
            sp = obs.span("exec.dispatch", route=self.route, sites=len(self.site_jobs))
        with sp, obs.annotation("exec.dispatch"):
            return self._flatten(fn(*((j.arrays, j.keys, j.fvals) for j in self._all_jobs())))

    def settle(self, host_out, dev_out) -> bool:
        """Consume one round's fetched outputs: slice the per-site blocks
        out of the ONE stats vector and run each site job's own settle
        verdict on its block.  True = finished (result set, or None for a
        decline); False = some site's capacities
        grew — dispatch the whole tree again."""
        from das_tpu_torch.query.compiler import ROUTE_COUNTS

        host_vals, host_valid, stats = self._unpack(host_out, True)
        vals, valid, _ = self._unpack(dev_out, False)
        off = 1
        grew = False
        for idx, j in enumerate(self._all_jobs()):
            blk_len = self._blk_len(j)
            blk = stats[off:off + blk_len]
            off += blk_len
            if idx in self._done:
                continue  # its capacities fit earlier; the block is stable
            if j.settle((blk,), None):
                if j.result is None:
                    # capacity ceiling: the staged tree owns the overflow
                    # policy (exactly the conjunction's decline)
                    return True
                self._done.add(idx)
            else:
                grew = True
        if grew:
            return False
        if any(j.result.reseed_needed for j in self._all_jobs()):
            # a site's reseed quirk fired: its answer under reordering is
            # not the reference's — the staged tree re-runs the whole tree
            # (its conjunction leaves resolve reseeds on the exact program)
            return True
        self.matched_any = any(j.result.count > 0 for j in self.site_jobs)
        self.result = self._make_result(vals, valid, int(stats[0]), host_vals, host_valid,
                                        stats)
        ROUTE_COUNTS[self.route] += 1
        return True


def run_tree_job(job: _TreeExecJob) -> _TreeExecJob:
    """Drive a tree job's dispatch/settle retry loop to the end: ONE host
    fetch a round."""
    while True:
        out = job.dispatch()
        t0 = time.perf_counter()
        with obs.annotation("exec.settle_fetch"):
            fetched = fetch(*out)
        if obs.enabled():
            fetch_s = time.perf_counter() - t0
            obs.counter("exec.fetches").inc()
            obs.histogram("exec.settle_fetch_ms").observe(fetch_s * 1e3)
            obs.REC.record("exec.settle_fetch", "X", t0, fetch_s, 0, {"tree": True})
        if job.settle(fetched, out):
            return job


def prepare_tree_job(ex, pos_sites, neg_plans, job_cls=_TreeExecJob) -> Optional[_TreeExecJob]:
    """Build one whole-tree job on executor `ex`: one count-only site job
    per positive Or branch (each takes the whole _exec_job path — planner
    order and seeds, learned capacities, index-join routing, multiway
    prefixes), plus one for the joint negative conjunction.  None when ANY
    site declines (missing bucket, capacity ceiling): the staged tree
    answers.  Site jobs count no per-answer route; the tree job counts its
    one fused_tree answer."""
    site_jobs = []
    for site in pos_sites:
        j = ex._exec_job(list(site), True)
        if j is None:
            return None
        j.count_route = False
        site_jobs.append(j)
    neg_job = None
    if neg_plans:
        neg_job = ex._exec_job(list(neg_plans), True)
        if neg_job is None:
            return None
        neg_job.count_route = False
    return job_cls(ex, site_jobs, neg_job)


class FusedExecutor:
    """Per-database executor: plan arguments, capacity seeds, the
    overflow-corrected capacities learned per plan shape, and the
    answered-result cache."""

    def __init__(self, db):
        self.db = db
        self.results = ResultCache(db)
        #: the tree executor's cache (query/tree.py): whole evaluated plan
        #: trees and tree-job answers keyed by plan-tree digest, same
        #: version guard
        self.tree_results = ResultCache(db)
        #: FusedTreeSig -> (fn, names) of build_fused_tree, bounded in
        #: _TreeExecJob.dispatch
        self._tree_progs: Dict[Tuple, Tuple] = {}
        #: count-batch work: groups run, lanes computed after dedup, members,
        #: and the groups of them that ran the exact second pass
        self.batch_counts = {"groups": 0, "lanes": 0, "members": 0, "exact_groups": 0}
        self._caps: Dict[Tuple, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
        self._exact_caps: Dict[Tuple, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
        # hashed capacities from DasConfig.cap_store_dir or a warm bundle,
        # consulted when the dicts above miss
        self._cap_store = CapStore("greedy", db.config.cap_store_dir)
        self._exact_cap_store = CapStore("exact", db.config.cap_store_dir)

    def _cap_salt(self) -> str:
        """Capacities depend on the store's size: the persistent store is
        keyed by it, so a large store's caps never seed a small one."""
        fin = self.db.fin
        return f"{fin.atom_count}:{fin.node_count}"

    def _learned_caps(self, mem, store, sigs, shape_lens):
        """Learned caps for the signature, in memory or else in the
        persistent store, if their per-stage lengths match: the same terms
        carry per-JOIN buffers on the chain but per-STEP buffers with a
        multiway step."""
        def valid(caps):
            return caps is not None and len(caps) == len(shape_lens) and all(
                len(c) == n for c, n in zip(caps, shape_lens))

        caps = mem.get(sigs)
        if valid(caps):
            return caps
        if not store:
            return None
        caps = store.load(sigs, self._cap_salt())
        return caps if valid(caps) else None

    def _remember_caps(self, sigs, term_caps, join_caps) -> None:
        self._caps[sigs] = (term_caps, join_caps)
        if self._cap_store.path is not None:
            self._cap_store.save(sigs, (term_caps, join_caps), self._cap_salt())

    def _remember_exact_caps(self, sigs, term_caps, chain_caps) -> None:
        self._exact_caps[sigs] = (term_caps, chain_caps)
        if self._exact_cap_store.path is not None:
            self._exact_cap_store.save(sigs, (term_caps, chain_caps), self._cap_salt())

    def _term_args(self, plan) -> Optional[Tuple[FusedTermSig, Tuple, object, np.ndarray]]:
        """Map a compiler.TermPlan to (sig, bucket_arrays, key, fixed_vals);
        None when the term's bucket is absent or empty."""
        bucket = self.db.dev.buckets.get(plan.arity)
        if bucket is None or bucket.size == 0:
            return None
        if plan.ctype is not None:
            route, p0, extra = ROUTE_CTYPE, -1, ()
            arrays = (bucket.key_ctype, bucket.order_by_ctype, bucket.targets, bucket.type_id)
            key = np.int64(plan.ctype)
        elif plan.type_id is not None and plan.fixed:
            p0, v0 = plan.fixed[0]
            route, extra = ROUTE_TYPE_POS, tuple(p for p, _ in plan.fixed[1:])
            arrays = (bucket.key_type_pos[p0], bucket.order_by_type_pos[p0],
                      bucket.targets, bucket.type_id)
            key = (np.int64(plan.type_id) << 32) | np.int64(v0)
        else:
            route, p0, extra = ROUTE_TYPE, -1, ()
            arrays = (bucket.key_type, bucket.order_by_type, bucket.targets, bucket.type_id)
            key = np.int32(plan.type_id)
        fixed_vals = np.asarray(
            [v for _, v in plan.fixed[1:]] if route == ROUTE_TYPE_POS else [],
            dtype=np.int32,
        )
        sig = FusedTermSig(
            arity=plan.arity, route=route, p0=p0, extra_fixed=extra,
            var_cols=plan.var_cols, eq_pairs=plan.eq_pairs,
            var_names=plan.var_names, negated=plan.negated,
        )
        return sig, arrays, key, fixed_vals

    def _map_terms(self, plans):
        """(sigs, arrays, keys, fvals) of the plans, or None when a bucket
        is missing."""
        mapped = [self._term_args(p) for p in plans]
        if any(m is None for m in mapped):
            return None
        return tuple(tuple(m[k] for m in mapped) for k in range(4))

    def _estimate(self, plan) -> int:
        return estimate_plan_rows(self.db, plan)

    def _join_cap_seed(self, plans, term_caps) -> int:
        """First-call join capacity seed: near the grounded terms' candidate
        sets when there are any (never below their exact row counts), else
        the largest term capacity."""
        cfg = self.db.config
        grounded = [
            self._estimate(p) for p in plans if p.fixed and p.ctype is None and not p.negated
        ]
        if grounded:
            mg = max(grounded)
            return _pow2_at_least(max(64, min(cfg.initial_result_capacity, 4 * mg), mg))
        return _pow2_at_least(max([cfg.initial_result_capacity, *term_caps]))

    def _group_cap_seed(self, sigs, est_rows) -> int:
        """_join_cap_seed for a count group: grounded-ness comes from the
        route; the estimates vary per member."""
        cfg = self.db.config
        grounded_idx = [
            t for t, s in enumerate(sigs) if s.route == ROUTE_TYPE_POS and not s.negated
        ]
        if grounded_idx:
            m = max(max(e[t] for t in grounded_idx) for e in est_rows)
            return _pow2_at_least(max(64, min(cfg.initial_result_capacity, 4 * m), m))
        term_cap_max = max(
            _pow2_at_least(max(e[t] for e in est_rows)) for t in range(len(sigs))
        )
        return _pow2_at_least(max(cfg.initial_result_capacity, term_cap_max))

    def _exec_job(self, plans, count_only: bool = False) -> Optional[_ExecJob]:
        """Order the plan, map its terms, seed the capacities.  None when a
        bucket is missing or the merged capacities exceed the ceiling.

        Behind `config.use_planner` the cost-based planner fixes the order,
        the per-step capacity seeds and the multiway prefix; when it
        declines (or is off) the greedy order and the blind seed apply."""
        from das_tpu_torch import planner as _planner

        planned = (
            _planner.plan_conjunction(self.db, plans)
            if _planner.enabled(self.db.config) else None
        )
        mw = planned.multiway if planned is not None else 0
        if planned is not None:
            ordered = [plans[i] for i in planned.order]
        else:
            ordered = order_plans(plans, self._estimate)
        same_order = same_positive_order(ordered, plans)
        mapped = self._map_terms(ordered)
        if mapped is None:
            return None
        sigs, arrays, keys, fvals = mapped
        cfg = self.db.config
        # exact host-side range counts => term capacities never overflow
        term_caps = tuple(_pow2_at_least(self._estimate(p)) for p in ordered)
        index_joins, index_right, arrays, term_caps = apply_index_joins(
            self.db.dev.buckets, sigs, arrays, term_caps, start_join=max(0, mw - 1)
        )
        n_positive = sum(1 for s in sigs if not s.negated)
        # one buffer per STEP: the multiway step plus the tail joins, or the
        # chain's P - 1 joins
        n_steps = (n_positive - mw + 1) if mw else max(0, n_positive - 1)
        if planned is not None and len(planned.join_cap_seeds) == n_steps:
            join_caps = planned.join_cap_seeds
        else:
            join_caps = tuple([self._join_cap_seed(ordered, term_caps)] * n_steps)
        learned = self._learned_caps(self._caps, self._cap_store, sigs,
                                     (len(term_caps), len(join_caps)))
        if learned is not None:
            term_caps = clamp_index_terms(
                tuple(max(a, b) for a, b in zip(term_caps, learned[0])), index_right
            )
            join_caps = tuple(max(a, b) for a, b in zip(join_caps, learned[1]))
        if max(term_caps + join_caps, default=0) > cfg.max_result_capacity:
            return None
        # counted once the job exists: a decline above falls back to the
        # staged path, which the planned/greedy split does not cover
        if planned is not None:
            _planner.record_planned(planned)
        else:
            _planner.PLANNER_COUNTS["greedy"] += 1
        return _ExecJob(self, count_only, same_order, sigs, arrays, keys, fvals, term_caps,
                        join_caps, index_joins, planned=planned, multiway=mw)

    def execute(self, plans, count_only: bool = False,
                use_cache: bool = False) -> Optional[FusedResult]:
        """Run the plan: dispatch a round, fetch its outputs in one host
        fetch, settle, and re-dispatch while the capacities grow.  None when
        a bucket is missing or a capacity would pass max_result_capacity
        (the staged path then answers).  With use_cache a result-cache hit
        answers with no device work; off by default, so that the single
        query path always runs the device."""
        if use_cache:
            key = self.results.key(plans, count_only)
            hit = self.results.get(key)
            if hit is not None:
                return hit
            version = self.results.version()
        job = self._exec_job(plans, count_only)
        if job is None:
            return None
        while True:
            out = job.dispatch()
            if job.settle(fetch(*out), out):
                if use_cache:
                    self.results.put(key, job.result, version)
                return job.result

    # -- the serving pipeline ------------------------------------------------

    def dispatch_many(self, plans_lists, count_only: bool = False, cache_only: bool = False):
        """First half of the serving pipeline: answer result-cache hits and
        enqueue every other job's first round, with no host fetch.  Returns
        the pending handle for settle_many / settle_many_iter.  With
        cache_only no job is dispatched: misses stay declines."""
        return dispatch_pending(self.results, self._exec_job, plans_lists, count_only,
                                cache_only=cache_only)

    def settle_many(self, pending) -> List[Optional[FusedResult]]:
        """Second half: one host fetch per retry round for all in-flight
        jobs, each job's verdict, re-dispatch of the jobs that grew."""
        return settle_pending(self.results, pending)

    def settle_many_iter(self, pending):
        """Streaming second half: (index, FusedResult) as each verdict
        lands (see settle_pending_iter)."""
        return settle_pending_iter(self.results, pending)

    def execute_many(self, plans_lists, count_only: bool = False) -> List[Optional[FusedResult]]:
        """Every query of the batch dispatched, then ONE host fetch per
        retry round for all of them; per query the same capacity retry,
        verdicts and learned capacities as execute()."""
        return self.settle_many(self.dispatch_many(plans_lists, count_only))

    def execute_exact(self, plans, count_only: bool = False) -> Optional[FusedResult]:
        """The plan in REFERENCE order (no reordering: the fold is
        order-sensitive) on the exact program (`run_exact`), whose reseed
        automaton answers the reseed quirk itself; one host fetch per
        retry round.  The host projects the full-K table onto the active
        state's columns.  None when a bucket is missing or the capacities
        pass EXACT_TERM_CAP_LIMIT or max_result_capacity (the staged path
        then answers)."""
        mapped = self._map_terms(plans)
        if mapped is None:
            return None
        sigs, arrays, keys, fvals = mapped
        cfg = self.db.config
        term_caps = tuple(_pow2_at_least(self._estimate(p)) for p in plans)
        P = sum(1 for s in sigs if not s.negated)
        chain_caps = tuple([self._join_cap_seed(plans, term_caps)] * len(_chain_order(P)))
        learned = self._learned_caps(self._exact_caps, self._exact_cap_store, sigs,
                                     (len(term_caps), len(chain_caps)))
        if learned is not None:
            term_caps = tuple(max(a, b) for a, b in zip(term_caps, learned[0]))
            chain_caps = tuple(max(a, b) for a, b in zip(chain_caps, learned[1]))
        # every term is materialized (a suffix chain has no index-join
        # form): past EXACT_TERM_CAP_LIMIT the staged path answers
        if max(term_caps) > min(cfg.max_result_capacity, EXACT_TERM_CAP_LIMIT):
            return None
        if max(chain_caps, default=0) > cfg.max_result_capacity:
            return None
        rounds = 0
        while True:
            rounds += 1
            sig = FusedExactSig(sigs, term_caps, chain_caps)
            run = run_exact
            if proflog.enabled():
                run = proflog.instrument("fused_exact", proflog.sig_digest(sig, count_only),
                                         run_exact)
            if count_only:
                (stats,) = fetch(run(sig, arrays, keys, fvals, True))
                vals = valid = host_vals = host_valid = None
            else:
                vals, valid, stats_dev = run(sig, arrays, keys, fvals, False)
                stats, host_vals, host_valid = fetch(stats_dev, vals, valid)
            new_tc = _grown(stats[3:3 + len(sigs)], term_caps)
            new_cc = _grown(stats[3 + len(sigs):], chain_caps)
            if new_tc == term_caps and new_cc == chain_caps:
                break
            if max(new_tc + new_cc, default=0) > cfg.max_result_capacity:
                return None
            term_caps, chain_caps = new_tc, new_cc
        self._remember_exact_caps(sigs, term_caps, chain_caps)
        _all, names_per_state, cols_per_state, _cap = exact_layout(sig)
        s_act = int(stats[1])
        cols = list(cols_per_state[s_act])
        if vals is not None and cols != list(range(vals.shape[1])):
            vals = vals[:, cols]
            host_vals = host_vals[:, cols]
        return FusedResult(
            var_names=names_per_state[s_act], vals=vals, valid=valid, count=int(stats[0]),
            reseed_needed=False, host_vals=host_vals, host_valid=host_valid,
            stats=stats, rounds=rounds,
        )

    # -- whole-tree jobs ---------------------------------------------------------

    def tree_exec_job(self, pos_sites, neg_plans=None) -> Optional["_TreeExecJob"]:
        """Prepare one whole-tree execution (see prepare_tree_job)."""
        return prepare_tree_job(self, pos_sites, neg_plans)

    def execute_tree(self, pos_sites, neg_plans=None) -> Optional["_TreeExecJob"]:
        """Run a whole Or/negation tree as ONE tree job (retry loop
        included).  Returns the settled job — result None means the staged
        tree must answer (a reseed verdict or the capacity ceiling) — or
        None when no job could form."""
        job = self.tree_exec_job(pos_sites, neg_plans)
        if job is None:
            return None
        return run_tree_job(job)

    # -- batched counting ------------------------------------------------------

    def _run_batch_group(self, run_lane, key_rows, fval_rows, n_terms, term_caps, caps,
                         make_sig, arrays):
        """Run one count group: identical lanes computed once, every lane's
        stats stacked on the device and fetched in ONE host fetch per retry
        round, capacities grown to the largest lane's overflow.  Lanes run
        one after another on one stream (the eager counterpart of the JAX
        package's vmap).  Returns (stats rows per member or None at the
        ceiling, term_caps, caps); rows follow the layout
        [count, flag, flag, *term_ranges, *step_totals].  `run_lane(term_caps,
        caps, keys, fixed_vals, arrays)` runs one lane over the group's
        bucket `arrays`; `make_sig(term_caps, caps)` is a round's signature,
        the program ledger's key and byte model of a round."""
        cfg = self.db.config
        seen: Dict[Tuple, int] = {}
        back: List[int] = []
        lanes = []
        for kr, fr in zip(key_rows, fval_rows):
            h = (tuple(np.asarray(k).tobytes() for k in kr),
                 tuple(np.asarray(f).tobytes() for f in fr))
            i = seen.get(h)
            if i is None:
                i = seen[h] = len(lanes)
                lanes.append((kr, fr))
            back.append(i)
        self.batch_counts["groups"] += 1
        self.batch_counts["lanes"] += len(lanes)
        self.batch_counts["members"] += len(back)
        def run_round(tc, cc, lanes, arrays):
            return torch.stack([run_lane(tc, cc, kr, fr, arrays) for kr, fr in lanes])

        while True:
            run = run_round
            if proflog.enabled():
                sig = make_sig(term_caps, caps)
                run = proflog.instrument("count_batch", proflog.sig_digest(sig, len(lanes)),
                                         run_round,
                                         model_bytes=partial(program_model_bytes, sig, arrays))
            stacked = run(term_caps, caps, lanes, arrays)
            # a count round's fetch is a settle fetch: retried, each
            # attempt counted
            ((stats,),) = retried_fetch(stage_many([(stacked,)]))
            ranges = stats[:, 3:3 + n_terms]
            totals = stats[:, 3 + n_terms:]
            new_tc = _grown(ranges.max(axis=0), term_caps)
            new_cc = _grown(totals.max(axis=0), caps) if totals.size else caps
            if new_tc == term_caps and new_cc == caps:
                return stats[np.asarray(back)], term_caps, caps
            if max(new_tc + new_cc) > cfg.max_result_capacity:
                return None, term_caps, caps
            term_caps, caps = new_tc, new_cc

    @staticmethod
    def _structural_key(p):
        return (
            p.negated, p.arity, p.ctype is not None, p.type_id is None,
            tuple(pos for pos, _ in p.fixed), p.var_cols, p.eq_pairs,
        )

    def _count_order(self, plans):
        """Ordering for count batches: when every positive term shares a
        common variable, by (log16 size class, structure) so same-shape
        lanes share one group; otherwise the greedy order."""
        pos = [p for p in plans if not p.negated]
        if len(pos) > 1:
            common = set(pos[0].var_names)
            for p in pos[1:]:
                common &= set(p.var_names)
            if common:
                neg = [p for p in plans if p.negated]
                return sorted(
                    pos,
                    key=lambda p: (
                        max(0, int(self._estimate(p)).bit_length() - 1) // 4,
                        self._structural_key(p),
                    ),
                ) + neg
        return order_plans(plans, self._estimate)

    @staticmethod
    def _canonical_plans(plans):
        """Rename variables by first occurrence (X0, X1, ...) so a count
        group's signature depends on join structure alone (a count is
        invariant under renaming; result-set paths must not use this)."""
        mapping: Dict[str, str] = {}
        out = []
        for p in plans:
            names = []
            for n in p.var_names:
                if n not in mapping:
                    mapping[n] = f"X{len(mapping)}"
                names.append(mapping[n])
            q = copy.copy(p)
            q.var_names = tuple(names)
            out.append(q)
        return out

    def count_batch(self, plans_list) -> List[Optional[int]]:
        """Count many queries per call.  Plans group by shape signature;
        each group runs its lanes in one retry loop with one host fetch per
        round.  Entries the greedy order cannot decide (a possible reseed)
        re-run on the exact reference-order program.  A count, or None
        where neither can answer (missing bucket, capacity ceilings): the
        caller then falls back to count_matches."""
        from das_tpu_torch.query import compiler as _compiler

        prepared = []   # (index, sigs, arrays, keys, fvals, ests, same_order)
        out: List[Optional[int]] = [None] * len(plans_list)
        groups: Dict[Tuple, List[int]] = {}
        # answered counts live in the result cache under count_only=True;
        # the delta_version read here guards the inserts
        cache_keys: Dict[int, Tuple] = {}
        cache_version = self.results.version()
        for idx, plans in enumerate(plans_list):
            n = trivial_plan_count(self.db, plans)
            if n is not None:
                out[idx] = n
                continue
            cache_keys[idx] = self.results.key(plans, True)
            hit = self.results.get(cache_keys[idx])
            if hit is not None:
                out[idx] = hit.count
                continue
            ordered = self._count_order(plans)
            same_order = same_positive_order(ordered, plans)
            mapped = self._map_terms(self._canonical_plans(ordered))
            if mapped is None:
                continue
            sigs, arrays, keys, fvals = mapped
            prepared.append((idx, sigs, arrays, keys, fvals,
                             tuple(self._estimate(p) for p in ordered), same_order))
            groups.setdefault(sigs, []).append(len(prepared) - 1)

        def answer(idx: int, n: int) -> None:
            out[idx] = n
            if idx in cache_keys:
                self.results.put(cache_keys[idx], FusedResult((), None, None, n, False),
                                 cache_version)

        cfg = self.db.config
        on_card = self.db.device.type == "cuda"
        for sigs, members in groups.items():
            term_caps = tuple(
                _pow2_at_least(max(prepared[m][5][t] for m in members))
                for t in range(len(sigs))
            )
            index_joins, index_right, group_arrays, term_caps = apply_index_joins(
                self.db.dev.buckets, sigs, prepared[members[0]][2], term_caps
            )
            n_joins = max(0, sum(1 for s in sigs if not s.negated) - 1)
            join_caps = tuple(
                [self._group_cap_seed(sigs, [prepared[m][5] for m in members])] * n_joins
            )
            learned = self._learned_caps(self._caps, self._cap_store, sigs,
                                     (len(term_caps), len(join_caps)))
            if learned is not None:
                term_caps = clamp_index_terms(
                    tuple(max(a, b) for a, b in zip(term_caps, learned[0])), index_right
                )
                join_caps = tuple(max(a, b) for a, b in zip(join_caps, learned[1]))
            if max(term_caps + join_caps, default=0) > cfg.max_result_capacity:
                continue
            if max(term_caps, default=0) > LARGE_TERM_BATCH_LIMIT:
                continue

            def run_lane(tc, jc, kr, fr, a, _s=sigs, _ij=index_joins):
                return run_conj(FusedPlanSig(_s, tc, jc, _ij), a, kr, fr)[2]

            stats, term_caps, join_caps = self._run_batch_group(
                run_lane, [prepared[m][3] for m in members],
                [prepared[m][4] for m in members], len(sigs), term_caps, join_caps,
                lambda tc, jc, _s=sigs, _ij=index_joins: FusedPlanSig(_s, tc, jc, _ij),
                group_arrays,
            )
            if stats is None:
                continue
            self._remember_caps(sigs, term_caps, join_caps)
            if on_card:
                # one count per query whose group ran the hand-written kernels
                _compiler.ROUTE_COUNTS["count_kernel"] += len(members)
            n_positive = sum(1 for s in sigs if not s.negated)
            for row, m in zip(stats, members):
                count, reseed, pos_empty = int(row[0]), bool(row[1]), bool(row[2])
                if reseed or (count == 0 and n_positive > 1 and not pos_empty
                              and not prepared[m][6]):
                    continue  # the greedy order cannot decide: exact pass below
                answer(prepared[m][0], count)

        # exact second pass: the undecided entries re-run in REFERENCE order
        # on the exact program, one group per shape
        exact_groups: Dict[Tuple, List[Tuple]] = {}
        for idx, plans in enumerate(plans_list):
            if out[idx] is not None:
                continue
            mapped = self._map_terms(self._canonical_plans(plans))
            if mapped is None:
                continue
            sigs, arrays, keys, fvals = mapped
            exact_groups.setdefault(sigs, []).append(
                (idx, arrays, keys, fvals, tuple(self._estimate(p) for p in plans))
            )
        for sigs, members in exact_groups.items():
            term_caps = tuple(
                _pow2_at_least(max(mm[4][t] for mm in members)) for t in range(len(sigs))
            )
            P = sum(1 for s in sigs if not s.negated)
            cap0 = self._group_cap_seed(sigs, [mm[4] for mm in members])
            chain_caps = tuple([cap0] * len(_chain_order(P)))
            learned = self._learned_caps(self._exact_caps, self._exact_cap_store, sigs,
                                         (len(term_caps), len(chain_caps)))
            if learned is not None:
                term_caps = tuple(max(a, b) for a, b in zip(term_caps, learned[0]))
                chain_caps = tuple(max(a, b) for a, b in zip(chain_caps, learned[1]))
            if max(term_caps) > min(cfg.max_result_capacity, EXACT_TERM_CAP_LIMIT):
                continue
            if max(chain_caps, default=0) > cfg.max_result_capacity:
                continue

            def run_lane(tc, cc, kr, fr, a, _s=sigs):
                return run_exact(FusedExactSig(_s, tc, cc), a, kr, fr, count_only=True)

            self.batch_counts["exact_groups"] += 1
            stats, term_caps, chain_caps = self._run_batch_group(
                run_lane, [mm[2] for mm in members], [mm[3] for mm in members],
                len(sigs), term_caps, chain_caps,
                lambda tc, cc, _s=sigs: FusedExactSig(_s, tc, cc), members[0][1],
            )
            if stats is None:
                continue
            self._remember_exact_caps(sigs, term_caps, chain_caps)
            for row, mm in zip(stats, members):
                answer(mm[0], int(row[0]))
        return out


def get_executor(db) -> FusedExecutor:
    """The per-database executor, cached on the device tables so a full
    rebuild (which replaces them) drops it; an incremental commit keeps it
    and its learned capacities, and its result cache moves to the new
    delta_version."""
    ex = getattr(db.dev, "_fused_executor", None)
    if ex is None or ex.db is not db:
        ex = FusedExecutor(db)
        db.dev._fused_executor = ex
    return ex


def is_sharded(db) -> bool:
    """Whether `db` is a mesh store (parallel/sharded_db.py's ShardedDB)."""
    from das_tpu_torch.parallel.sharded_db import ShardedDB

    return isinstance(db, ShardedDB)


def executor_of(db, create: bool = True):
    """The executor that serves `db`, the one place that picks it: the
    sharded executor on a mesh store, the single-device one on a TensorDB,
    None on a host store (and, with create=False, where none exists yet)."""
    from das_tpu_torch.storage.tensor_db import TensorDB

    if is_sharded(db):
        if not create:
            return getattr(db.tables, "_fused_executor", None)
        from das_tpu_torch.parallel.fused_sharded import get_sharded_executor

        return get_sharded_executor(db)
    if isinstance(db, TensorDB):
        return get_executor(db) if create else getattr(db.dev, "_fused_executor", None)
    return None


# -- warm-state bundle (storage/durable.py) ----------------------------------
#
# What a restored store would otherwise re-learn: the learned capacities
# (each re-learned one is a retry round), the planner estimator's exact
# statistics (host searches) and count-only cache entries.  All of it is a
# hint, keyed by delta_version like the result cache.


def _jsonable(obj):
    """Nested tuples as lists (the keys come back through _tuplize)."""
    if isinstance(obj, tuple):
        return [_jsonable(x) for x in obj]
    return obj


def _tuplize(obj):
    if isinstance(obj, list):
        return tuple(_tuplize(x) for x in obj)
    return obj


def export_warm_state(db) -> Optional[Dict]:
    """The warm bundle written beside a snapshot: the learned capacities
    (stable-hash keyed, `CapStore.view`), the count-only result-cache
    entries (host ints; binding tables stay on the device and are not
    persisted) and the planner estimator's memoized statistics at the
    store's version."""
    ex = executor_of(db)
    if ex is None:
        return None
    out: Dict = {"delta_version": int(getattr(db, "delta_version", 0))}
    caps = {}
    # the sharded executor keeps no CapStore: its bundle carries counts and
    # the planner's statistics only, as in das_tpu
    if hasattr(ex, "_cap_store"):
        salt = ex._cap_salt()
        for tag, mem in (("_cap_store", ex._caps), ("_exact_cap_store", ex._exact_caps)):
            view = getattr(ex, tag).view(mem, salt)
            if view:
                caps[tag] = view
    out["caps"] = caps
    counts = []
    with ex.results._lock:
        for key, entry in ex.results._data.items():
            if entry.vals is None and isinstance(entry.count, int):
                counts.append([_jsonable(key), entry.count])
    out["counts"] = counts
    est = getattr(db, "_planner_estimator", None)
    if est is not None and est.version == getattr(db, "delta_version", None):
        out["planner"] = {
            "rows": [[_jsonable(k), v] for k, v in est._rows.items()],
            "distinct": [[_jsonable(k), v] for k, v in est._distinct.items()],
        }
    return out


def apply_warm_state(db, state: Dict) -> bool:
    """Apply a warm bundle onto a freshly restored store.  A bundle
    recorded at a version the store is no longer at (the WAL replayed past
    the snapshot) is discarded whole."""
    if int(state.get("delta_version", -1)) != int(getattr(db, "delta_version", 0)):
        return False
    ex = executor_of(db)
    if ex is None:
        return False
    for tag, data in (state.get("caps") or {}).items():
        store = getattr(ex, tag, None)
        if store is not None:
            store._data.update(data)
    version = getattr(db, "delta_version", None)
    for key, n in state.get("counts") or ():
        ex.results.put(_tuplize(key), FusedResult((), None, None, int(n), False), version)
    planner = state.get("planner")
    if planner:
        from das_tpu_torch.planner.stats import estimator_for

        est = estimator_for(db)
        est._rows.update((_tuplize(k), int(v)) for k, v in planner.get("rows", ()))
        est._distinct.update((_tuplize(k), int(v)) for k, v in planner.get("distinct", ()))
    return True
