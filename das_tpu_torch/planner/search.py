"""Join-order search: costed whole-plan programs (port of the conjunction
planner of `das_tpu/planner/search.py`).

Selinger-style dynamic programming over connected subsets of the positive
terms, left-deep chains only, up to `DEFAULT_DP_MAX` clauses (8); wider
conjunctions take a greedy order by estimated join output.  When the
positive terms are connected in reference order and at least one is
grounded, the reference order is kept (`reference_order_authoritative`,
shared with the greedy `order_plans`): the program is then the reference
fold itself and its reseed flag is authoritative.  Negated terms filter at
the end.

A star prefix — clauses that each share exactly one variable v with what
came before — may be fused into one k-way multiway step
(kernels/multiway.py) when `multiway_mode` allows and the byte model says
it beats the chain.  `plan_tree` costs a whole Or/negation tree for the
tree executor's fused form: one plan per conjunction site plus the union
and anti-join placement (`PlannedTree`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from das_tpu_torch.planner import cost as pcost
from das_tpu_torch.planner.stats import RelEstimate, estimator_for
from das_tpu_torch.query.fused import reference_order_authoritative

#: exact-DP clause ceiling; beyond it the greedy tail orders the conjunction
DEFAULT_DP_MAX = 8

#: "auto" multiway routing needs at least this many fused clauses (a
#: 2-clause star has no intermediate to delete); "on" routes any >= 2
MULTIWAY_AUTO_MIN_K = 3


def multiway_mode(config) -> str:
    """Multiway routing from the config: "auto", "on" or "off"."""
    mode = str(config.use_multiway).lower()
    if mode in ("on", "1", "true"):
        return "on"
    if mode in ("off", "0", "false"):
        return "off"
    return "auto"


@dataclass(frozen=True)
class PlannedProgram:
    """One costed whole-plan decision, fixed before anything runs.

    order          — permutation into the caller's plan list (positives in
                     join order, then negatives)
    est_term_rows  — exact per-term candidate rows, in `order`
    est_join_rows  — estimated output rows per STEP (with multiway: the
                     k-way output first, then one per tail join)
    join_cap_seeds — initial capacity per step buffer, same layout
    route          — the answer route expected (ops/counters.py ROUTE_KEYS)
    method         — "dp" / "greedy_tail" / "ref_order"
    cost           — the model's bytes-moved figure for the whole chain
    multiway       — leading positives fused into one k-way step (0 = none)
    """

    order: Tuple[int, ...]
    est_term_rows: Tuple[int, ...]
    est_join_rows: Tuple[int, ...]
    join_cap_seeds: Tuple[int, ...]
    route: str
    method: str
    cost: float
    multiway: int = 0


def _shares_var(a, b) -> bool:
    return bool(set(a.var_names) & set(b.var_names))


def _connected(plans: List) -> bool:
    """All positive terms form one variable-connected component."""
    if len(plans) <= 1:
        return True
    seen = {0}
    grew = True
    while grew:
        grew = False
        for i, p in enumerate(plans):
            if i in seen:
                continue
            if any(_shares_var(p, plans[j]) for j in seen):
                seen.add(i)
                grew = True
    return len(seen) == len(plans)


def _index_join_eligible(plan) -> bool:
    """Mirror of query/fused.py plan_index_joins' right-side test: an
    ordered whole-type probe, positive, no repeated variables."""
    return (
        not plan.negated
        and not plan.eq_pairs
        and not plan.fixed
        and plan.ctype is None
        and plan.type_id is not None
    )


def _join_step(est, acc, right, right_plan):
    """One left-deep join step: (folded RelEstimate, capacity-relevant
    rows, shared-variable count, exact?)."""
    shared = [v for v in acc.dv if v in right.dv]
    out = est.join_estimate(acc, right)
    cap_rows = out.rows
    exact = (
        len(shared) == 1
        and acc.plan is not None and right.plan is not None
        and est.exact_join_rows(acc.plan, right.plan, shared[0]) is not None
    )
    if shared and _index_join_eligible(right_plan):
        pr, p_exact = est.pair_join_rows(acc, right, shared[0])
        if pr >= cap_rows:
            cap_rows, exact = pr, p_exact
    return out, cap_rows, len(shared), exact


def _max_capacity(db) -> int:
    return int(db.config.max_result_capacity)


def _chain_estimates(est, terms: List, order: Tuple[int, ...]):
    """(est_join_rows, join_cap_seeds, cost, step_costs) of one left-deep
    order; step_costs are the per-join costs the multiway router compares
    its one step against."""
    rels = [est.term_estimate(terms[i]) for i in order]
    acc = rels[0]
    widths = [len(terms[i].var_names) for i in order]
    width = widths[0]
    total = pcost.term_cost(int(acc.rows), width)
    join_rows: List[int] = []
    max_cap = _max_capacity(est.db)
    caps: List[int] = []
    step_costs: List[float] = []
    for n in range(1, len(order)):
        right = rels[n]
        out, cap_rows, n_pairs, exact = _join_step(est, acc, right, terms[order[n]])
        out_width = width + sum(1 for v in terms[order[n]].var_names if v not in acc.dv)
        total += pcost.term_cost(int(right.rows), widths[n])
        step = pcost.join_step_cost(
            acc.rows, width, right.rows, widths[n], n_pairs, cap_rows, out_width, max_cap,
        )
        total += step
        step_costs.append(step)
        join_rows.append(int(cap_rows))
        caps.append(pcost.cap_for(cap_rows, max_cap, exact=exact))
        acc = out
        width = out_width
    return tuple(join_rows), tuple(caps), total, step_costs


def _multiway_prefix(terms: List, order: Tuple[int, ...]):
    """(m, v): the longest prefix of the ordered positives that forms a
    star on one shared variable v; m == 0 when there is none."""
    if len(order) < 2:
        return 0, None
    seen = set(terms[order[0]].var_names)
    shared0 = set(terms[order[1]].var_names) & seen
    if len(shared0) != 1:
        return 0, None
    v = next(iter(shared0))
    m = 1
    for idx in order[1:]:
        t = terms[idx]
        if (set(t.var_names) & seen) != {v}:
            break
        seen |= set(t.var_names)
        m += 1
    return (m if m >= 2 else 0), v


def _star_chain_seeds(est, terms, order, join_rows, caps, max_cap):
    """When the chain runs a star prefix, its deeper intermediates are
    (t+2)-way star joins whose exact size multiway_rows computes: seed
    them margin-free from that instead of the independence model."""
    m, v = _multiway_prefix(terms, order)
    if m < 3:
        return join_rows, caps
    join_rows, caps = list(join_rows), list(caps)
    for t in range(1, m - 1):
        prefix = [terms[order[j]] for j in range(t + 2)]
        rows, exact = est.multiway_rows(prefix, v)
        if exact:
            join_rows[t] = int(rows)
            caps[t] = pcost.cap_for(rows, max_cap, exact=True)
    return tuple(join_rows), tuple(caps)


def _dp_order(est, terms: List) -> Tuple[int, ...]:
    """Best left-deep order over connected subsets, within the model."""
    n = len(terms)
    rels = [est.term_estimate(t) for t in terms]
    widths = [len(t.var_names) for t in terms]
    max_cap = _max_capacity(est.db)
    best: Dict[frozenset, Tuple[float, Tuple[int, ...], RelEstimate, int]] = {}
    for i in range(n):
        best[frozenset((i,))] = (
            pcost.term_cost(int(rels[i].rows), widths[i]), (i,), rels[i], widths[i],
        )
    for size in range(1, n):
        for state, (c, order, acc, width) in list(best.items()):
            if len(state) != size:
                continue
            for j in range(n):
                if j in state:
                    continue
                if not any(_shares_var(terms[j], terms[i]) for i in state):
                    continue
                out, cap_rows, n_pairs, _exact = _join_step(est, acc, rels[j], terms[j])
                out_width = width + sum(1 for v in terms[j].var_names if v not in acc.dv)
                c2 = c + pcost.term_cost(int(rels[j].rows), widths[j])
                c2 += pcost.join_step_cost(
                    acc.rows, width, rels[j].rows, widths[j], n_pairs, cap_rows,
                    out_width, max_cap,
                )
                key = state | {j}
                cur = best.get(key)
                if cur is None or c2 < cur[0]:
                    best[key] = (c2, order + (j,), out, out_width)
    return best[frozenset(range(n))][1]


def _greedy_order(est, terms: List) -> Tuple[int, ...]:
    """Past the DP ceiling: start from the smallest term, always extend
    with the connected term of least estimated join output."""
    n = len(terms)
    rels = [est.term_estimate(t) for t in terms]
    start = min(range(n), key=lambda i: rels[i].rows)
    order = [start]
    acc = rels[start]
    remaining = set(range(n)) - {start}
    while remaining:
        connected = [
            j for j in remaining if any(_shares_var(terms[j], terms[i]) for i in order)
        ] or list(remaining)
        j = min(connected, key=lambda j: _join_step(est, acc, rels[j], terms[j])[1])
        acc = _join_step(est, acc, rels[j], terms[j])[0]
        order.append(j)
        remaining.remove(j)
    return tuple(order)


def plan_conjunction(db, plans, *, n_shards: int = 1) -> Optional[PlannedProgram]:
    """A conjunction as a costed whole-plan program, or None when the
    planner declines (no positive term, disconnected positives): the caller
    then takes the greedy order.  `n_shards > 1` scales the capacity seeds
    to per-shard buffers (the sharded executor's join_caps unit) with the
    2x skew headroom of its probe capacities.  Counts nothing (the
    executor counts)."""
    if not plans:
        return None
    est = estimator_for(db)
    pos_idx = [i for i, p in enumerate(plans) if not p.negated]
    neg_idx = [i for i, p in enumerate(plans) if p.negated]
    if not pos_idx:
        return None
    positives = [plans[i] for i in pos_idx]
    if not _connected(positives):
        return None

    config = db.config
    if reference_order_authoritative(positives):
        order_pos: Tuple[int, ...] = tuple(range(len(positives)))
        method = "ref_order"
    elif len(positives) <= DEFAULT_DP_MAX:
        order_pos = _dp_order(est, positives)
        method = "dp"
    else:
        order_pos = _greedy_order(est, positives)
        method = "greedy_tail"

    join_rows, caps, total, step_costs = _chain_estimates(est, positives, order_pos)

    # multiway routing: fuse a star prefix into one k-way step whose one
    # output buffer seeds from the exact intersection product
    mw = 0
    mode = multiway_mode(config)
    max_cap = _max_capacity(db)
    if mode != "off" and len(positives) >= 2:
        m, v = _multiway_prefix(positives, order_pos)
        if m >= 2:
            prefix = [positives[order_pos[j]] for j in range(m)]
            # every prefix clause materializes as a term table: keep the
            # chain when one would pass the capacity ceiling
            feasible = all(pcost.pow2_at_least(est.rows(p)) <= max_cap for p in prefix)
            if feasible:
                mw_rows, mw_exact = est.multiway_rows(prefix, v)
                width0 = len(prefix[0].var_names)
                out_width = len(set().union(*(set(p.var_names) for p in prefix)))
                mw_cost = pcost.multiway_step_cost(
                    est.rows(prefix[0]), width0,
                    [(est.rows(p), len(p.var_names)) for p in prefix[1:]],
                    mw_rows, out_width, max_cap,
                )
                if mode == "on" or (
                    m >= MULTIWAY_AUTO_MIN_K and mw_cost < sum(step_costs[: m - 1])
                ):
                    mw = m
                    mw_cap = pcost.cap_for(mw_rows, max_cap, exact=mw_exact)
                    total = total - sum(step_costs[: m - 1]) + mw_cost
                    join_rows = (int(mw_rows),) + join_rows[m - 1:]
                    caps = (mw_cap,) + caps[m - 1:]

    if mw == 0 and len(positives) >= 3:
        join_rows, caps = _star_chain_seeds(est, positives, order_pos, join_rows, caps,
                                            max_cap)

    if n_shards > 1:
        caps = tuple(pcost.pow2_at_least(max(64, 2 * (-(-c // n_shards)))) for c in caps)
    order = tuple(pos_idx[i] for i in order_pos) + tuple(neg_idx)
    term_rows = tuple(est.rows(plans[i]) for i in order)
    # the hand-written kernels run on a card, their plain versions elsewhere
    on_card = db.device.type == "cuda"
    if n_shards > 1:
        route = "sharded_multiway" if mw else ("sharded_kernel" if on_card else "sharded")
    elif mw:
        route = "fused_multiway"
    else:
        route = "fused_kernel" if on_card else "fused"
    return PlannedProgram(
        order=order,
        est_term_rows=term_rows,
        est_join_rows=join_rows,
        join_cap_seeds=caps,
        route=route,
        method=method,
        cost=float(total),
        multiway=mw,
    )


# ---------------------------------------------------------------------------
# whole-tree planning: one costed job for an Or/Not tree
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlannedTree:
    """One costed whole-TREE decision (query/tree.py tree_fusion_sites):
    per-site conjunction plans plus the union/anti placement the tree job
    hard-codes.

    site_plans     — one Optional[PlannedProgram] per positive Or branch
                     (None = the site's planner declined; the executor
                     takes its greedy order for that site and the tree
                     still fuses)
    neg_plan       — plan of the joint negative conjunction, when the Or
                     carries syntactic Not children (de-Morgan branch)
    est_site_rows  — estimated final rows per positive site, in site order
    est_union_rows — estimated union size (sum of sites — the dedup can
                     only shrink it)
    union_after    — index into the site list after which the union
                     (concat + dedup) runs; always len(site_plans)
    anti_after_union — the anti join (negation difference) runs AFTER the
                     union, against the joint-negative table
    route          — "fused_tree" (ops/counters.py ROUTE_KEYS)
    cost           — summed site costs + the union's modeled bytes
    """

    site_plans: Tuple[Optional[PlannedProgram], ...]
    neg_plan: Optional[PlannedProgram]
    est_site_rows: Tuple[int, ...]
    est_union_rows: int
    union_after: int
    anti_after_union: bool
    route: str
    cost: float


def _site_out_rows(db, plans, planned) -> int:
    """Estimated FINAL rows of one conjunction site: the last join's
    estimate when planned, else the largest positive term's exact count."""
    if planned is not None and planned.est_join_rows:
        return int(planned.est_join_rows[-1])
    if planned is not None:
        return int(planned.est_term_rows[0])
    est = estimator_for(db)
    pos = [p for p in plans if not p.negated]
    if est is None or not pos:
        return 0
    return max(est.rows(p) for p in pos)


def plan_tree(db, pos_sites, neg_plans=None, *, n_shards: int = 1) -> Optional[PlannedTree]:
    """Cost a whole Or/negation plan tree: one PlannedProgram per
    conjunction site (plan_conjunction), the union's size estimate and the
    union/anti placement.  None when there is nothing to plan.  Counts
    nothing (explain() calls it too)."""
    if not pos_sites and not neg_plans:
        return None
    site_plans = tuple(plan_conjunction(db, list(site), n_shards=n_shards)
                       for site in pos_sites)
    neg_plan = (plan_conjunction(db, list(neg_plans), n_shards=n_shards)
                if neg_plans else None)
    site_rows = tuple(
        _site_out_rows(db, site, planned) for site, planned in zip(pos_sites, site_plans)
    )
    union_rows = int(sum(site_rows))
    out_width = max(
        (len({v for p in site if not p.negated for v in p.var_names}) for site in pos_sites),
        default=1,
    )
    cost = sum(p.cost for p in site_plans if p is not None)
    if neg_plan is not None:
        cost += neg_plan.cost
    # the union's modeled bytes: one concat + dedup pass over the summed
    # site windows, priced as materialization
    cost += float(union_rows) * max(out_width, 1) * pcost.ROW_BYTES
    return PlannedTree(
        site_plans=site_plans,
        neg_plan=neg_plan,
        est_site_rows=site_rows,
        est_union_rows=union_rows,
        union_after=len(site_plans),
        anti_after_union=neg_plans is not None and bool(neg_plans),
        route="sharded_tree_fused" if n_shards > 1 else "fused_tree",
        cost=float(cost),
    )
