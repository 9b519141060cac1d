"""Fused execution of compiled conjunctive queries (port of the main-path
subset of `das_tpu/query/fused.py`).

The JAX package traces a whole plan — every probe, join and anti-join —
into ONE jitted program.  Here the same plan runs as an eager sequence of
kernel launches on the current stream (`run_conj`).  Every buffer is sized
on the host before launch from static capacities, exactly as the JAX
program sizes them, and all exact counts the host needs land in one
stats vector

    [count, reseed, any_pos_empty, *term_ranges, *join_totals]

that comes back in ONE host fetch per retry round (`FETCH_COUNTS`).  On
overflow the capacities double and the plan re-runs.  Two reference
quirks are decided from the stats exactly as in the JAX package: an
empty positive term is a definitive empty answer, and an accumulator
that a join empties with positive terms remaining (the reseed quirk) —
or an empty answer under a reordered fold — sends the query to the staged
path (query/compiler.py execute_plan), which reproduces the quirk.

Join order is the greedy `order_plans` with the blind capacity seeds; the
cost-based planner, the multiway kernel, the exact reference-order
program, batched counting and the result cache are later slices."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from das_tpu_torch import kernels
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


@dataclass
class FusedResult:
    var_names: Tuple[str, ...]
    vals: torch.Tensor       # [cap, k] int32 (device)
    valid: torch.Tensor      # [cap] bool (device)
    count: int
    reseed_needed: bool      # the staged path must answer
    stats: np.ndarray        # the final round's stats vector
    rounds: int              # retry rounds run (one host fetch each)
    host_vals: Optional[np.ndarray] = None   # fetched with the stats
    host_valid: Optional[np.ndarray] = None


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


def plan_index_joins(sigs: Tuple[FusedTermSig, ...]):
    """Static per-join index-join eligibility: the right side must be an
    ordered whole-type probe (ROUTE_TYPE, no extra verification, no
    repeated variables), positive, and actually share a variable.
    Returns (index_joins, right_terms: term index -> join position)."""
    positives, _neg, _names, join_meta, _anti = fold_join_meta(sigs)
    index_joins = []
    right_terms = {}
    for n in range(max(0, len(positives) - 1)):
        i = positives[n + 1]
        t = sigs[i]
        pairs, _extra = join_meta[n]
        if (t.route == ROUTE_TYPE and not t.negated and not t.eq_pairs
                and not t.extra_fixed and pairs):
            index_joins.append(t.var_cols[pairs[0][1]])
            right_terms[i] = n
        else:
            index_joins.append(-1)
    return tuple(index_joins), right_terms


def apply_index_joins(buckets, sigs, arrays, term_caps):
    """Decide per-join index-join routing and rewrite the affected terms'
    inputs: the positional posting index instead of the type-sorted window,
    and a token capacity (the term is never materialized)."""
    index_joins, index_right = plan_index_joins(sigs)
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


def run_conj(sig: FusedPlanSig, bucket_arrays, keys, fixed_vals):
    """Run ONE conjunction — every probe, join and anti-join — as eager
    launches on the current stream.  Returns (acc_vals, acc_valid, stats)
    with stats the int64 device vector [count, reseed, any_pos_empty,
    *term_ranges, *join_totals]; nothing here waits for the device."""
    positives, _negatives, _names, join_meta, anti_meta = fold_join_meta(sig.terms)
    index_joins = sig.index_joins or tuple([-1] * max(0, len(positives) - 1))
    index_right = {positives[1 + t]: t for t, p in enumerate(index_joins) if p >= 0}
    dev = bucket_arrays[0][0].device
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    tables = {}
    term_ranges = []
    pos_count = {}
    for i, t in enumerate(sig.terms):
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
        sorted_keys, perm, targets, _tid = bucket_arrays[i]
        vals, mask, rng = kernels.probe_term_table(
            sorted_keys, perm, targets, keys[i], fixed_vals[i], sig.term_caps[i],
            var_cols=t.var_cols, eq_pairs=t.eq_pairs, extra_fixed=t.extra_fixed,
        )
        # no per-term dedup: every route pins the link type, so distinct
        # candidate links always yield distinct variable tuples
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
    for t, i in enumerate(positives[1:]):
        pairs, extra = join_meta[t]
        jc = sig.join_caps[t]
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
        if t < len(positives) - 2:
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


def fetch(*tensors) -> List[np.ndarray]:
    """ONE host fetch of device tensors: every copy is queued without
    blocking, then the stream is synchronized once."""
    FETCH_COUNTS["n"] += 1
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class _ExecJob:
    """One execute()'s mutable state: ordered term arguments and the
    capacities, which grow between retry rounds."""

    def __init__(self, same_order, sigs, arrays, keys, fvals, term_caps,
                 join_caps, index_joins, index_right):
        self.same_order = same_order
        self.sigs = sigs
        self.arrays = arrays
        self.keys = keys
        self.fvals = fvals
        self.term_caps = term_caps
        self.join_caps = join_caps
        self.index_joins = index_joins
        self.index_right = index_right
        self.rounds = 0

    def plan_sig(self) -> FusedPlanSig:
        return FusedPlanSig(self.sigs, self.term_caps, self.join_caps, self.index_joins)


class FusedExecutor:
    """Per-database executor: plan arguments, capacity seeds and the
    overflow-corrected capacities learned per plan shape."""

    def __init__(self, db):
        self.db = db
        self._caps: Dict[Tuple, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}

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

    def _exec_job(self, plans) -> Optional[_ExecJob]:
        """Order the plan, map its terms, seed the capacities.  None when a
        bucket is missing or the merged capacities exceed the ceiling."""
        ordered = order_plans(plans, self._estimate)
        same_order = same_positive_order(ordered, plans)
        mapped = []
        for plan in ordered:
            m = self._term_args(plan)
            if m is None:
                return None
            mapped.append(m)
        sigs = tuple(m[0] for m in mapped)
        arrays = tuple(m[1] for m in mapped)
        keys = tuple(m[2] for m in mapped)
        fvals = tuple(m[3] for m in mapped)
        cfg = self.db.config
        # exact host-side range counts => term capacities never overflow
        term_caps = tuple(_pow2_at_least(self._estimate(p)) for p in ordered)
        index_joins, index_right, arrays, term_caps = apply_index_joins(
            self.db.dev.buckets, sigs, arrays, term_caps
        )
        n_positive = sum(1 for s in sigs if not s.negated)
        join_caps = tuple([self._join_cap_seed(ordered, term_caps)] * max(0, n_positive - 1))
        learned = self._caps.get(sigs)
        if learned is not None:
            term_caps = clamp_index_terms(
                tuple(max(a, b) for a, b in zip(term_caps, learned[0])), index_right
            )
            join_caps = tuple(max(a, b) for a, b in zip(join_caps, learned[1]))
        if max(term_caps + join_caps, default=0) > cfg.max_result_capacity:
            return None
        return _ExecJob(same_order, sigs, arrays, keys, fvals, term_caps, join_caps,
                        index_joins, index_right)

    def execute(self, plans, count_only: bool = False) -> Optional[FusedResult]:
        """Run the plan, one host fetch per round, doubling capacities on
        overflow.  None when a bucket is missing or a capacity would pass
        max_result_capacity (the staged path then answers and owns the
        overflow policy)."""
        job = self._exec_job(plans)
        if job is None:
            return None
        names = fold_join_meta(job.sigs)[2]
        while True:
            job.rounds += 1
            vals, valid, stats_dev = run_conj(job.plan_sig(), job.arrays, job.keys, job.fvals)
            if count_only:
                (stats,) = fetch(stats_dev)
                host_vals = host_valid = None
            else:
                stats, host_vals, host_valid = fetch(stats_dev, vals, valid)
            ranges = stats[3:3 + len(job.sigs)]
            jcounts = stats[3 + len(job.sigs):]
            new_tc = tuple(
                _pow2_at_least(int(r)) if int(r) > c else c
                for r, c in zip(ranges, job.term_caps)
            )
            new_jc = tuple(
                _pow2_at_least(int(t)) if int(t) > c else c
                for t, c in zip(jcounts, job.join_caps)
            )
            if new_tc == job.term_caps and new_jc == job.join_caps:
                break
            if max(new_tc + new_jc, default=0) > self.db.config.max_result_capacity:
                return None
            job.term_caps, job.join_caps = new_tc, new_jc
        self._caps[job.sigs] = (job.term_caps, job.join_caps)
        count, reseed, pos_empty = int(stats[0]), bool(stats[1]), bool(stats[2])
        n_positive = sum(1 for s in job.sigs if not s.negated)
        return FusedResult(
            var_names=names, vals=vals, valid=valid, count=count,
            # an empty result under a REORDERED fold could mask the
            # reseed quirk of the reference order: the staged path redoes
            # it; an empty POSITIVE TERM is always definitive
            reseed_needed=reseed or (
                count == 0 and n_positive > 1 and not pos_empty and not job.same_order
            ),
            stats=stats, rounds=job.rounds, host_vals=host_vals, host_valid=host_valid,
        )


def get_executor(db) -> FusedExecutor:
    """The per-database executor, cached on the device tables so a
    `refresh()` (which rebuilds them) drops it."""
    ex = getattr(db.dev, "_fused_executor", None)
    if ex is None or ex.db is not db:
        ex = FusedExecutor(db)
        db.dev._fused_executor = ex
    return ex
