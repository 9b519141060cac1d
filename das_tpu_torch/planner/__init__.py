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
`snapshot()` adds their ratio."""

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
