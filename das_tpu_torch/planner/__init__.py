"""Cost-based whole-plan query planner (port of `das_tpu/planner/`).

Turns a conjunction into a costed program before anything runs: the join
order from a Selinger-style DP over the posting-index degree statistics
(search.py, stats.py), each step priced against the kernel byte model
(cost.py, kernels/budget.py), an estimated initial capacity per step, and
the choice of fusing a star prefix into one k-way multiway step.

Consumer: `query/fused.py FusedExecutor._exec_job`, behind
`DasConfig.use_planner` ("auto" = on).  Count batches keep their
structural ordering (`_count_order`), as in the JAX package.

The planner only chooses among orders the executor already accepts:
answers are the same for every order, and capacity seeds only move the
starting rung of the overflow-retry ladder.

`PLANNER_COUNTS` (keys from ops/counters.py PLANNER_KEYS) tracks planned
vs greedy traffic, retry rounds, and summed estimated vs actual step rows;
`snapshot()` adds their ratio.  `explain(db, query)` renders one query's
costed plan — a conjunction's, a whole fused tree's (`plan_tree`) or one
per conjunction site of a staged tree — and with execute=True runs it
through the executor's dispatch/settle halves and reports the actual rows
beside the estimates."""

from __future__ import annotations

from typing import Dict

from das_tpu_torch.ops.counters import PLANNER_KEYS

PLANNER_COUNTS: Dict[str, int] = {k: 0 for k in PLANNER_KEYS}


def reset_planner_counts() -> None:
    for k in PLANNER_COUNTS:
        PLANNER_COUNTS[k] = 0


def enabled(config) -> bool:
    """Planner routing from the config: off only for "off"/"0"/"false"."""
    return str(config.use_planner).lower() not in ("off", "0", "false")


def snapshot() -> Dict[str, float]:
    """The counters plus actual/estimated summed step rows of settled
    planned jobs (1.0 = the statistics describe the data)."""
    out = dict(PLANNER_COUNTS)
    est = out.get("est_rows", 0)
    out["actual_vs_est_ratio"] = round(out.get("actual_rows", 0) / est, 4) if est else None
    return out


def record_planned(planned) -> None:
    """One planner-driven conjunction, by the search that ordered it."""
    PLANNER_COUNTS["planned"] += 1
    method = planned.method
    if method == "dp":
        PLANNER_COUNTS["dp"] += 1
    elif method == "greedy_tail":
        PLANNER_COUNTS["greedy_tail"] += 1
    else:
        PLANNER_COUNTS["ref_order"] += 1


def observe_settle(planned, actual_join_rows, rounds: int, shards: int = 1) -> None:
    """Fold one settled planned job into the counters: retry rounds paid
    and estimated vs actual step output rows.  The sharded executor's
    actuals are worst-shard totals, so its estimates are scaled to the
    even split over `shards`."""
    if rounds <= 1:
        PLANNER_COUNTS["round0"] += 1
    else:
        PLANNER_COUNTS["retries"] += rounds - 1
    est = sum(-(-int(r) // max(shards, 1)) for r in planned.est_join_rows)
    act = sum(int(r) for r in actual_join_rows)
    PLANNER_COUNTS["est_rows"] += est
    PLANNER_COUNTS["actual_rows"] += act
    from das_tpu_torch import obs

    if obs.enabled():
        obs.event(
            "planner.observe", est_rows=est, actual_rows=act,
            per_step_est=list(planned.est_join_rows),
            per_step_actual=[int(r) for r in actual_join_rows],
            retry_rounds=rounds - 1,
        )


# re-exports: the public planner surface
from das_tpu_torch.planner.search import (  # noqa: E402,F401
    PlannedProgram,
    PlannedTree,
    plan_conjunction,
    plan_tree,
)
from das_tpu_torch.planner.stats import (  # noqa: E402,F401
    CardinalityEstimator,
    estimator_for,
)


def _term_brief(plan) -> Dict:
    """One term of explain's `order`."""
    return {
        "arity": plan.arity,
        "type_id": plan.type_id,
        "ctype": plan.ctype,
        "fixed": list(plan.fixed),
        "vars": list(plan.var_names),
        "negated": plan.negated,
    }


#: sentinel: "no precomputed plan — run plan_conjunction here" (None is a
#: computed outcome, the planner's decline)
_UNPLANNED = object()


def _sharded(db) -> bool:
    from das_tpu_torch.query.fused import is_sharded

    return is_sharded(db)


def _n_shards(db) -> int:
    return db.mesh.size if _sharded(db) else 1


def _executor(db):
    from das_tpu_torch.query.fused import executor_of

    return executor_of(db)


def _explain_plans(db, plans, execute: bool, planned=_UNPLANNED,
                   compile_report: bool = False) -> Dict:
    sharded = _sharded(db)
    if planned is _UNPLANNED:
        PLANNER_COUNTS["explain"] += 1
        planned = plan_conjunction(db, list(plans), n_shards=_n_shards(db))
    out: Dict = {
        "route": (planned.route if planned is not None
                  else ("sharded" if sharded else "fused")),
        "planner_enabled": enabled(db.config),
        "planned": planned is not None,
    }
    if planned is not None:
        out.update(
            method=planned.method,
            cost_bytes=planned.cost,
            order=[_term_brief(plans[i]) for i in planned.order],
            est_term_rows=list(planned.est_term_rows),
            est_join_rows=list(planned.est_join_rows),
            join_cap_seeds=list(planned.join_cap_seeds),
            # leading positives fused into one k-way step (0 = binary chain)
            multiway=planned.multiway,
        )
    if not execute:
        return out
    # the job runs through the executor's own dispatch/settle halves, so
    # "actual" describes the program a query would run (learned caps too)
    from das_tpu_torch.query.fused import fetch

    job = _executor(db)._exec_job(list(plans), False)
    if job is None:
        out["actual"] = None  # declined: the staged path answers
        if compile_report:
            out["compile"] = None
        return out
    while True:
        dev = job.dispatch()
        if job.settle(fetch(*dev), dev):  # one host fetch a round
            break
    result = job.result
    out["actual"] = {
        "count": None if result is None else result.count,
        "term_rows": list(job.last_ranges or ()),
        "join_rows": list(job.last_join_rows or ()),
        "retry_rounds": max(0, job.rounds - 1),
        "reseed_fallback": bool(getattr(result, "reseed_needed", False)),
    }
    if compile_report:
        out["compile"] = _compile_block(job.plan_sig(), "sharded" if sharded else "fused")
    return out


def _compile_block(sig, site_hint: str) -> Dict:
    """The explain(compile=True) block: the program ledger's rows
    (obs/proflog.py) for the executed signature's digest, falling back to
    the site's rows when the digest has none (a program first called
    before the ledger was on); `enabled` False with no rows says why
    nothing is there."""
    from das_tpu_torch.obs import proflog

    digest = proflog.sig_digest(sig, False)
    rows = proflog.rows(digest=digest)
    if not rows:
        rows = proflog.rows(site=site_hint)
    return {"enabled": proflog.enabled(), "digest": digest, "rows": rows}


def _site_actual(j) -> Dict:
    return {
        "count": j.result.count,
        "term_rows": list(j.last_ranges or ()),
        "join_rows": list(j.last_join_rows or ()),
    }


def _explain_tree_fused(db, fusable, execute: bool, compile_report: bool = False) -> Dict:
    """The whole-tree fused plan: per-site costed conjunction plans, the
    union/anti placement the tree job hard-codes and per-branch estimated
    rows — with execute=True, the actual per-site rows, retry rounds and
    the final count of the ONE tree job."""
    PLANNER_COUNTS["explain"] += 1
    pos_sites, neg_plans, _const = fusable
    sharded = _sharded(db)
    pt = plan_tree(db, pos_sites, neg_plans, n_shards=_n_shards(db))
    # per-site detail from the plans plan_tree already computed: one
    # explain call plans each site once and counts once
    site_plans = pt.site_plans if pt is not None else tuple(None for _ in pos_sites)
    out: Dict = {
        "route": (pt.route if pt is not None
                  else ("sharded_tree_fused" if sharded else "fused_tree")),
        "planned": pt is not None,
        "tree_fused": True,
        "planner_enabled": enabled(db.config),
        "sites": [
            _explain_plans(db, site, False, planned=sp)
            for site, sp in zip(pos_sites, site_plans)
        ],
        "neg_site": (
            _explain_plans(db, neg_plans, False,
                           planned=pt.neg_plan if pt is not None else None)
            if neg_plans else None
        ),
    }
    if pt is not None:
        out.update(
            cost_bytes=pt.cost,
            est_site_rows=list(pt.est_site_rows),
            est_union_rows=pt.est_union_rows,
            # the union (concat + dedup) runs after ALL positive sites; the
            # anti join (difference) after the union
            union_after=pt.union_after,
            anti_after_union=pt.anti_after_union,
        )
    if not execute:
        return out
    job = _executor(db).execute_tree(pos_sites, neg_plans)
    if job is None or job.result is None:
        out["actual"] = None  # declined: the staged tree answers
        if compile_report:
            out["compile"] = None
        return out
    if compile_report:
        out["compile"] = _compile_block(job.tree_sig(),
                                        "sharded_tree" if sharded else "fused_tree")
    out["actual"] = {
        "count": job.result.count,
        # the mesh union dedups shard-locally (cross-shard duplicates die
        # in the host set), so a sharded count bounds the distinct answers
        # from above; single-device counts are exact after the dedup
        "count_is_upper_bound": sharded,
        "matched_any": job.matched_any,
        "retry_rounds": max(0, job.rounds - 1),
        "programs": job.rounds,
        "sites": [_site_actual(j) for j in job.site_jobs],
        "neg_site": _site_actual(job.neg_job) if job.neg_job is not None else None,
    }
    return out


def explain(db, query, execute: bool = False, compile: bool = False) -> Dict:
    """What the planner decided for `query`: order, route, estimated rows,
    capacity seeds; with execute=True also the actual per-stage rows and
    retry rounds; compile=True (implies execute) adds the `compile` block.
    An Or/negation tree in the fusable subset reports the whole-tree fused
    plan (site order, union/anti placement, per-branch estimated rows);
    other trees report one entry per ordered-conjunction site
    (query/tree.py conj_sites); a query outside the tree executor's
    language reports route "host"."""
    from das_tpu_torch.query import compiler as qc

    execute = execute or compile
    plans = qc.plan_query(db, query)
    if plans is not None:
        return _explain_plans(db, plans, execute, compile_report=compile)
    from das_tpu_torch.query.plan import NotCompilable, build_plan
    from das_tpu_torch.query.tree import conj_sites, tree_fusion_enabled, tree_fusion_sites

    try:
        node = build_plan(db, query)
    except NotCompilable:
        return {"route": "host", "planned": False}
    fusable = tree_fusion_sites(node)
    if fusable is not None and tree_fusion_enabled(db.config):
        return _explain_tree_fused(db, fusable, execute, compile_report=compile)
    sites = conj_sites(node)
    return {
        "route": "tree",
        "planned": bool(sites),
        "sites": [_explain_plans(db, site, execute, compile_report=compile)
                  for site in sites],
    }
