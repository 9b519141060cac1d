"""Cost model for whole-plan pricing (copy of `das_tpu/planner/cost.py`).

Each candidate join step is priced as BYTES MOVED: the estimated
materialized output (rows x int32 row width) plus the byte model of the
step at the capacity the estimate implies (kernels/budget.py), with a
penalty where the model says the stage falls off the kernel routes.  The
model only has to ORDER plans; every constant is a power of two so tests
can pin exact costs."""

from __future__ import annotations

from das_tpu_torch.kernels import budget

#: int32 columns everywhere
ROW_BYTES = 4

#: headroom multiplier between an estimated row count and its capacity
CAP_MARGIN = 2

#: pricing penalty for a step priced off the kernel routes
LOWERED_PENALTY = 4

#: flat per-stage charge (bytes-equivalent): breaks ties toward shorter chains
STAGE_OVERHEAD = 1 << 12


def pow2_at_least(n: int, lo: int = 64) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def cap_for(est_rows: float, max_capacity: int, exact: bool = False) -> int:
    """Initial capacity for an estimated intermediate: margin, power of
    two, clamped to the ceiling.  `exact` drops the margin: a degree
    product bounds what the overflow stats can report."""
    want = int(est_rows) + 1 if exact else int(est_rows * CAP_MARGIN) + 1
    return min(pow2_at_least(max(64, want)), max(int(max_capacity), 64))


def term_cost(rows: int, width: int) -> float:
    """Materializing one probed term table."""
    return float(rows) * (width or 1) * ROW_BYTES + STAGE_OVERHEAD


def multiway_step_cost(left_rows: float, left_width: int, tails, cap_rows: float,
                       out_width: int, max_capacity: int) -> float:
    """One k-way multiway step: the byte model at the capacity the
    estimate implies plus ONE materialized output (the chain pays k-1
    stages and k-2 intermediates).  `tails` is (rows, width) per non-first
    clause, priced at their common padded width."""
    cap = cap_for(cap_rows, max_capacity)
    kpad = max([w for _r, w in tails] + [1])
    plan = budget.multiway_plan(
        int(min(left_rows, 2**31 - 1)), max(left_width, 1),
        tuple((int(min(r, 2**31 - 1)), kpad) for r, _w in tails),
        max(out_width, 1), cap,
    )
    stage = float(plan.resident_bytes + plan.block_bytes)
    if plan.route == budget.ROUTE_LOWERED:
        stage *= LOWERED_PENALTY
    return stage + cap_rows * out_width * ROW_BYTES + STAGE_OVERHEAD


def join_step_cost(left_rows: float, left_width: int, right_rows: float,
                   right_width: int, n_pairs: int, cap_rows: float, out_width: int,
                   max_capacity: int) -> float:
    """One binary join: the byte model at the capacity the estimate
    implies plus the estimated materialized window."""
    cap = cap_for(cap_rows, max_capacity)
    plan = budget.join_plan(
        int(min(left_rows, 2**31 - 1)), max(left_width, 1),
        int(min(right_rows, 2**31 - 1)), max(right_width, 1),
        max(n_pairs, 1), max(out_width, 1), cap,
    )
    stage = float(plan.resident_bytes + plan.block_bytes)
    if plan.route == budget.ROUTE_LOWERED:
        stage *= LOWERED_PENALTY
    return stage + cap_rows * out_width * ROW_BYTES + STAGE_OVERHEAD
