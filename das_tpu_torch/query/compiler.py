"""Compiled conjunctive queries: the device fast path (port of
`das_tpu/query/compiler.py`).

A conjunctive query over ordered link patterns compiles to term plans;
the fused executor (query/fused.py) runs them as kernel launches with one
host fetch per retry round, one query at a time or a batch at a time
(`execute_fused_many_*`).  A reseed verdict (the reference's
empty-accumulator quirk) re-runs on the exact reference-order program.
When that declines, or at a capacity ceiling, the staged pipeline here
answers: per term one probe kernel and an exact dedup, per
join one join kernel with its own capacity retry, then the anti-joins,
syncing a count to the host between stages.

Compilable subset: `And`/bare patterns of *ordered* `Link`s (targets:
Node | grounded | Variable) and *ordered* `LinkTemplate`s, plus `Not` of
those.  Unordered links, `Or` and nesting go to the tree executor
(query/tree.py); what even it cannot plan goes to the host algebra
(query/ast.py), which is answer-identical."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from das_tpu_torch import kernels
from das_tpu_torch.core.exceptions import CapacityOverflowError
from das_tpu_torch.core.hashing import ExpressionHasher, hex_to_i64
from das_tpu_torch.ops.counters import ROUTE_KEYS
from das_tpu_torch.ops.join import dedup_table
from das_tpu_torch.query import assignment as asn_mod
from das_tpu_torch.query.assignment import OrderedAssignment
from das_tpu_torch.query.ast import (
    And,
    Link,
    LinkTemplate,
    LogicalExpression,
    Node,
    Not,
    PatternMatchingAnswer,
    TypedVariable,
    Variable,
)
from das_tpu_torch.query import starcount
from das_tpu_torch.query.fused import fetch, get_executor, is_sharded, trivial_plan_count
from das_tpu_torch.storage.tensor_db import TensorDB, _next_capacity


@dataclass
class TermPlan:
    arity: int
    type_id: Optional[int]          # None only for template probes
    fixed: Tuple[Tuple[int, int], ...]   # (position, global_row)
    var_names: Tuple[str, ...]           # one per output column
    var_cols: Tuple[int, ...]            # first position of each var
    eq_pairs: Tuple[Tuple[int, int], ...]  # same-var repeated positions
    ctype: Optional[int] = None          # template probe key (int64)
    negated: bool = False


@dataclass
class BindingTable:
    var_names: Tuple[str, ...]
    vals: torch.Tensor    # [cap, k] int32
    valid: torch.Tensor   # [cap] bool
    count: int
    host_vals: Optional[np.ndarray] = None   # fetched with the stats
    host_valid: Optional[np.ndarray] = None


class NotCompilable(Exception):
    pass


class UnknownAtom(NotCompilable):
    """A grounded node or link type that doesn't exist in the KB: the
    reference answers no-match for these, not an error."""


#: How queries were executed (keys from ops/counters.py ROUTE_KEYS):
#: "fused" = the fused executor answered, "fused_kernel" = such an answer
#: from a store on the card (its hand-written kernels ran), "staged" = the
#: staged pipeline, "tree" = the tree executor (query/tree.py), of which
#: "fused_tree" = answered by one whole-tree job (counted at its settle),
#: "host" = the host algebra (counted by `dispatch`);
#: "fused_multiway" = a fused answer whose program ran a multiway step
#: (counted at settle, also for count_matches); "count_kernel" =
#: count_batch entries whose group ran the hand-written kernels; "star" =
#: star conjunctions counted by the closed-form fold (query/starcount.py;
#: counted by `count_matches` and by the miner's `count_many`).
ROUTE_COUNTS = dict.fromkeys(ROUTE_KEYS, 0)


def reset_route_counts() -> None:
    for k in ROUTE_COUNTS:
        ROUTE_COUNTS[k] = 0


def _plan_term(db: TensorDB, term, negated: bool) -> TermPlan:
    if isinstance(term, LinkTemplate):
        if not term.ordered:
            raise NotCompilable("unordered template")
        names, cols, eq = [], [], []
        for p, tv in enumerate(term.targets):
            if not isinstance(tv, TypedVariable):
                raise NotCompilable("template target")
            if tv.name in names:
                eq.append((cols[names.index(tv.name)], p))
            else:
                names.append(tv.name)
                cols.append(p)
        type_hashes = [
            db.data.table.get_named_type_hash(t)
            for t in [term.link_type, *[tv.type for tv in term.targets]]
        ]
        ctype_hex = ExpressionHasher.composite_hash(type_hashes)
        return TermPlan(
            arity=len(term.targets), type_id=None, fixed=(), var_names=tuple(names),
            var_cols=tuple(cols), eq_pairs=tuple(eq), ctype=int(hex_to_i64(ctype_hex)),
            negated=negated,
        )
    if not isinstance(term, Link) or not term.ordered:
        raise NotCompilable("not an ordered link")
    if term.atom_type in db.data.pattern_black_list:
        # no pattern index exists for blacklisted types; the host algebra
        # (whose get_matched_links consults the same blacklist) answers
        raise NotCompilable("blacklisted link type")
    fixed, names, cols, eq = [], [], [], []
    for p, target in enumerate(term.targets):
        if isinstance(target, TypedVariable):
            raise NotCompilable("typed variable in link")
        if isinstance(target, Variable):
            if target.name in names:
                eq.append((cols[names.index(target.name)], p))
            else:
                names.append(target.name)
                cols.append(p)
        elif isinstance(target, Node):
            row = db.fin.row_of_hex.get(target.get_handle(db))
            if row is None:
                raise UnknownAtom("unknown grounded node")
            fixed.append((p, row))
        else:
            raise NotCompilable("unsupported target kind")
    if not names:
        raise NotCompilable("fully grounded term")
    type_id = db._type_id(term.atom_type)
    if type_id is None:
        raise UnknownAtom("unknown link type")
    return TermPlan(
        arity=len(term.targets), type_id=type_id, fixed=tuple(fixed),
        var_names=tuple(names), var_cols=tuple(cols), eq_pairs=tuple(eq),
        negated=negated,
    )


#: plan_query's verdict, under unknown_atom_empty, for a conjunction with a
#: positive term grounded on an atom absent from the store: no match
EMPTY_PLAN = object()


def plan_query(db: TensorDB, query: LogicalExpression, unknown_atom_empty: bool = False):
    """Term plans, or None when the query isn't compilable (or names a
    positive grounded atom absent from the store, which the host algebra
    answers as no-match).  With unknown_atom_empty that last case returns
    EMPTY_PLAN instead, so a caller composing plans (the sharded store's Or
    decomposition) can skip the branch as a static no-match."""
    if asn_mod.CONFIG.get("no_overload"):
        return None
    if isinstance(query, (Link, LinkTemplate)):
        terms = [query]
    elif isinstance(query, And):
        terms = query.terms
    else:
        return None
    if not terms:
        return None
    plans = []
    try:
        for term in terms:
            if isinstance(term, Not):
                try:
                    plans.append(_plan_term(db, term.term, True))
                except UnknownAtom:
                    continue  # tabu on a nonexistent atom never excludes
            else:
                plans.append(_plan_term(db, term, False))
    except UnknownAtom:
        return EMPTY_PLAN if unknown_atom_empty else None
    except NotCompilable:
        return None
    if not plans or all(p.negated for p in plans):
        return None
    return plans


def _run_term(db: TensorDB, plan: TermPlan) -> Optional[BindingTable]:
    """Staged term: the probe kernel with a capacity retry, then an exact
    dedup.  None when no candidate survives (or the bucket is absent)."""
    m = get_executor(db)._term_args(plan)
    if m is None:
        return None
    sig, arrays, key, fvals = m
    bucket = db.dev.buckets[plan.arity]
    cap = min(db.config.initial_result_capacity, max(bucket.size, 16))
    while True:
        vals, mask, rng = kernels.probe_term_table(
            arrays[0], arrays[1], arrays[2], key, fvals, cap,
            var_cols=sig.var_cols, eq_pairs=sig.eq_pairs, extra_fixed=sig.extra_fixed,
        )
        if int(rng) <= cap:
            break
        cap = _next_capacity(int(rng), cap, db.config.max_result_capacity)
    vals, keep, count = dedup_table(vals, mask)
    n = int(count)
    if n == 0:
        return None
    return BindingTable(plan.var_names, vals, keep, n)


def _join(db: TensorDB, left: BindingTable, right: BindingTable) -> BindingTable:
    shared = [
        (left.var_names.index(v), right.var_names.index(v))
        for v in left.var_names if v in right.var_names
    ]
    extra = tuple(i for i, v in enumerate(right.var_names) if v not in left.var_names)
    out_names = left.var_names + tuple(v for v in right.var_names if v not in left.var_names)
    cfg = db.config
    cap = max(64, min(left.count * right.count, cfg.initial_result_capacity))
    while True:
        vals, valid, total = kernels.join_tables(
            left.vals, left.valid, right.vals, right.valid, tuple(shared), extra, cap,
        )
        t = int(total)
        if t <= cap:
            break
        if cap >= cfg.max_result_capacity:
            raise CapacityOverflowError(
                f"join needs {t} rows > max_result_capacity {cfg.max_result_capacity}"
            )
        cap = min(max(cap * 2, t), cfg.max_result_capacity)
    vals, keep, count = dedup_table(vals, valid)
    return BindingTable(out_names, vals, keep, int(count))


def execute_plan(db: TensorDB, plans: List[TermPlan]) -> Optional[BindingTable]:
    """The staged pipeline in reference order; the final table, or None
    for no match."""
    tabu_tables: List[BindingTable] = []
    accumulated: Optional[BindingTable] = None
    for plan in plans:
        table = _run_term(db, plan)
        if plan.negated:
            if table is not None:
                tabu_tables.append(table)
            continue
        if table is None:
            return None  # positive term unmatched -> whole And fails
        if accumulated is None or accumulated.count == 0:
            # reference quirk: an empty accumulator is re-seeded by the
            # next positive term (query/ast.py And.matched)
            accumulated = table
        else:
            accumulated = _join(db, accumulated, table)
    if accumulated is None:
        return None
    valid = accumulated.valid
    for tabu in tabu_tables:
        if not set(tabu.var_names) <= set(accumulated.var_names):
            continue  # tabu with extra vars never excludes (NO_COVERING)
        pairs = tuple(
            (accumulated.var_names.index(v), tabu.var_names.index(v))
            for v in tabu.var_names
        )
        valid = kernels.anti_join(accumulated.vals, valid, tabu.vals, tabu.valid, pairs)
    return BindingTable(accumulated.var_names, accumulated.vals, valid, int(valid.sum()))


def _execute_fused(db: TensorDB, plans: List[TermPlan],
                   count_only: bool = False) -> Optional[BindingTable]:
    """The fused executor's answer.  A reseed verdict re-runs on the exact
    reference-order program (`execute_exact`), whose automaton answers the
    reseed quirk.  None when the staged path must answer: a missing
    bucket, a capacity ceiling, or a result still flagged."""
    ex = get_executor(db)
    res = ex.execute(plans, count_only=count_only)
    if res is not None and res.reseed_needed:
        res = ex.execute_exact(plans, count_only=count_only)
    if res is None or res.reseed_needed:
        return None
    return _binding_table(res)


def _binding_table(res) -> BindingTable:
    return BindingTable(
        res.var_names, res.vals, res.valid, res.count,
        host_vals=res.host_vals, host_valid=res.host_valid,
    )


def execute_fused_many_dispatch(db: TensorDB, plans_lists: List[List[TermPlan]],
                                cache_only: bool = False):
    """First half of the batched path: answer result-cache hits and
    enqueue the batch's fused rounds, with no host fetch.  Returns the
    pending handle for the settle calls below.  With cache_only nothing is
    dispatched."""
    return get_executor(db).dispatch_many(plans_lists, cache_only=cache_only)


def execute_fused_many_settle_iter(db: TensorDB, plans_lists: List[List[TermPlan]], pending):
    """Streaming second half: yields `(index, BindingTable or None)` as
    each verdict becomes final.  A reseed-flagged entry is answered in
    place by the exact program.  None = the caller replays the entry on
    the staged path: a settle-time decline (capacity ceiling, a result
    still flagged) yields in verdict order as its round lands, and the
    dispatch-time declines (no job, no cache hit) yield last."""
    ex = get_executor(db)
    seen = [False] * len(plans_lists)
    for i, res in ex.settle_many_iter(pending):
        seen[i] = True
        if res is not None and res.reseed_needed:
            res = ex.execute_exact(plans_lists[i])
        if res is None or res.reseed_needed:
            yield i, None
            continue
        yield i, _binding_table(res)
    for i, done in enumerate(seen):
        if not done:
            yield i, None


def execute_fused_many_settle(db: TensorDB, plans_lists: List[List[TermPlan]],
                              pending) -> List[Optional[BindingTable]]:
    """The list form of execute_fused_many_settle_iter (None = the staged
    path must answer that entry)."""
    out: List[Optional[BindingTable]] = [None] * len(plans_lists)
    for i, table in execute_fused_many_settle_iter(db, plans_lists, pending):
        out[i] = table
    return out


def execute_fused_many(db: TensorDB,
                       plans_lists: List[List[TermPlan]]) -> List[Optional[BindingTable]]:
    """Batched `_execute_fused`: every query dispatched before ONE host
    fetch per retry round for all of them; declined entries come back
    None, as from the single path."""
    pending = execute_fused_many_dispatch(db, plans_lists)
    return execute_fused_many_settle(db, plans_lists, pending)


def execute_sharded_many_dispatch(db, plans_lists: List[List[TermPlan]],
                                  cache_only: bool = False):
    """The sharded store's first half of the batched path: answer
    result-cache hits and enqueue every other job's first round on the
    mesh, with no host fetch (cache_only: nothing is dispatched)."""
    from das_tpu_torch.parallel.fused_sharded import get_sharded_executor

    return get_sharded_executor(db).dispatch_many(plans_lists, cache_only=cache_only)


def execute_sharded_many_settle_iter(db, plans_lists, pending):
    """Yields `(index, ShardedFusedResult or None)` as each verdict lands:
    settle-time declines (ceiling, reseed) in verdict order, dispatch-time
    declines last.  A None is for the caller to answer on the staged mesh
    pipeline (db.sharded_execute)."""
    from das_tpu_torch.parallel.fused_sharded import get_sharded_executor

    seen = [False] * len(plans_lists)
    for i, res in get_sharded_executor(db).settle_many_iter(pending):
        seen[i] = True
        yield i, (None if res is None or res.reseed_needed else res)
    for i, done in enumerate(seen):
        if not done:
            yield i, None


def execute_sharded_many_settle(db, plans_lists, pending) -> List:
    """The list form of execute_sharded_many_settle_iter."""
    out = [None] * len(plans_lists)
    for i, res in execute_sharded_many_settle_iter(db, plans_lists, pending):
        out[i] = res
    return out


def materialize(db: TensorDB, table: Optional[BindingTable],
                answer: PatternMatchingAnswer) -> bool:
    """Convert a device binding table into frozen OrderedAssignments."""
    from das_tpu_torch import obs

    if table is None or table.count == 0:
        return False
    with obs.span("exec.materialize", rows=table.count,
                  prefetched=table.host_vals is not None):
        if table.host_vals is not None:
            vals, valid = table.host_vals, table.host_valid
        else:
            vals, valid = fetch(table.vals, table.valid)
        hexes = db.fin.hex_of_row
        for row in vals[valid]:
            a = OrderedAssignment()
            ok = True
            for name, val in zip(table.var_names, row):
                if not a.assign(name, hexes[int(val)]):
                    ok = False
                    break
            if ok and a.freeze():
                answer.assignments.add(a)
    return bool(answer.assignments)


def query_on_device(db: TensorDB, query: LogicalExpression,
                    answer: PatternMatchingAnswer) -> Optional[bool]:
    """Compiled execution; None when the query is not compilable (the
    caller answers on the host algebra).  Ordered conjunctions take the
    fused path; everything else in the logical language (Or, unordered
    links, nested And/Or, negation trees) runs on the tree executor
    (query/tree.py)."""
    plans = plan_query(db, query)
    if plans is not None:
        table = _execute_fused(db, plans)
        if table is None:
            table = execute_plan(db, plans)
            ROUTE_COUNTS["staged"] += 1
        else:
            ROUTE_COUNTS["fused"] += 1
            if db.device.type == "cuda":
                ROUTE_COUNTS["fused_kernel"] += 1
        return materialize(db, table, answer)
    from das_tpu_torch.query.tree import query_tree

    matched = query_tree(db, query, answer)
    if matched is not None:
        ROUTE_COUNTS["tree"] += 1
    return matched


def dispatch(db, query: LogicalExpression, answer: PatternMatchingAnswer) -> bool:
    """Route one query: the mesh for a sharded store, the device path for
    a TensorDB, the host algebra otherwise — and for queries outside the
    compiled language or whose join outgrows max_result_capacity."""
    matched = None
    sharded = is_sharded(db)
    if sharded or isinstance(db, TensorDB):
        try:
            if sharded:
                matched = db.query_sharded(query, answer)
                if matched is not None:
                    ROUTE_COUNTS["sharded"] += 1
                    if db.device.type == "cuda":
                        ROUTE_COUNTS["sharded_kernel"] += 1
            else:
                matched = query_on_device(db, query, answer)
        except CapacityOverflowError:
            answer.assignments.clear()
            answer.negation = False
            matched = None
    if matched is None:
        ROUTE_COUNTS["host"] += 1
        matched = query.matched(db, answer)
    return matched


def explain(db, query: LogicalExpression, execute: bool = False,
            compile: bool = False) -> dict:
    """The planner's costed plan for `query` (planner.explain); here so the
    facade shares one entry point with `dispatch`."""
    from das_tpu_torch import planner

    return planner.explain(db, query, execute=execute, compile=compile)


def count_matches_staged(db: TensorDB, plans: List[TermPlan]) -> int:
    """The staged pipeline's count for plans the fused path already
    declined: re-trying the fused executor would only find the same reseed
    or overflow verdict again, at the cost of another dispatch."""
    table = execute_plan(db, plans)
    return 0 if table is None else table.count


def count_matches(db: TensorDB, query: LogicalExpression) -> Optional[int]:
    """Exact match count without materializing a conjunction's
    assignments: a single term on the host, a star conjunction (one shared
    variable, the miner's joint) by the closed-form degree fold
    (query/starcount.py), any other conjunction on the fused executor.  A
    query outside the conjunctive subset is counted by the tree executor,
    which materializes (its counts are exact only after the host set's
    identity); None where the tree executor declines."""
    plans = plan_query(db, query)
    if plans is not None:
        n = trivial_plan_count(db, plans)
        if n is not None:
            return n
        n = starcount.try_star_count(db, plans)
        if n is not None:
            ROUTE_COUNTS["star"] += 1
            return n
        table = _execute_fused(db, plans, count_only=True)
        if table is None:
            table = execute_plan(db, plans)
        return 0 if table is None else table.count
    from das_tpu_torch.query.tree import query_tree

    answer = PatternMatchingAnswer()
    matched = query_tree(db, query, answer)
    if matched is None:
        return None
    return len(answer.assignments) if matched else 0
