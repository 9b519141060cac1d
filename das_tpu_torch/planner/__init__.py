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
costed plan, and with execute=True runs it through the executor's
dispatch/settle halves and reports the actual rows beside the estimates."""

from __future__ import annotations

import hashlib
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


def observe_settle(planned, actual_join_rows, rounds: int) -> None:
    """Fold one settled planned job into the counters: retry rounds paid
    and estimated vs actual step output rows."""
    if rounds <= 1:
        PLANNER_COUNTS["round0"] += 1
    else:
        PLANNER_COUNTS["retries"] += rounds - 1
    PLANNER_COUNTS["est_rows"] += sum(int(r) for r in planned.est_join_rows)
    PLANNER_COUNTS["actual_rows"] += sum(int(r) for r in actual_join_rows)


# re-exports: the public planner surface
from das_tpu_torch.planner.search import PlannedProgram, plan_conjunction  # noqa: E402,F401
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


def _explain_plans(db, plans, execute: bool, compile_report: bool = False) -> Dict:
    PLANNER_COUNTS["explain"] += 1
    planned = plan_conjunction(db, list(plans))
    out: Dict = {
        "route": planned.route if planned is not None else "fused",
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
    from das_tpu_torch.query.fused import fetch, get_executor

    job = get_executor(db)._exec_job(list(plans), False)
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
        # no program ledger in the port yet: the block the JAX package
        # gives with its ledger off, keyed by the same digest (the md5 of
        # the executed signature's repr, folded to 16 hex chars)
        digest = hashlib.md5(repr((job.plan_sig(), False)).encode()).hexdigest()[:16]
        out["compile"] = {"enabled": False, "digest": digest, "rows": []}
    return out


def explain(db, query, execute: bool = False, compile: bool = False) -> Dict:
    """What the planner decided for a conjunctive `query`: order, route,
    estimated rows, capacity seeds; with execute=True also the actual
    per-stage rows and retry rounds; compile=True (implies execute) adds
    the `compile` block.  A query outside the compiled conjunctive subset
    gives route "host", which answers it here (the JAX package reports its
    device tree executor's sites there; that comes with the tree
    executor)."""
    from das_tpu_torch.query import compiler as qc

    execute = execute or compile
    plans = qc.plan_query(db, query)
    if plans is None:
        return {"route": "host", "planned": False}
    return _explain_plans(db, plans, execute, compile_report=compile)
