"""The planner's byte model of the kernel stages (copy of the pricing part
of `das_tpu/kernels/budget.py`).

This is the TPU's VMEM model, kept unchanged so that the port's planner
prices — and therefore orders and seeds — every plan exactly as the JAX
package does.  Nothing in the port routes on it: a CUDA tensor always goes
to the hand-written kernel.  The planner (planner/cost.py) prices each
join or multiway step by the stage's resident and streamed bytes, with a
penalty when the model says the stage would fall off the kernel routes.
The program ledger reads every stage model, the probe, index-join and
anti-join ones too (query/fused.py `program_model_bytes`): the modeled
bytes of a call beside what the card allocated for it.

Differences from the JAX module: the budget is the fixed pricing constant
`DEFAULT_VMEM_BUDGET` (no environment override), and the interpreter's
compile-cost guard is gone — it priced the CPU interpreter, which the port
does not have, so the port prices like `das_tpu` on a TPU.  Below 2^22
rows the guard never fires, so the two packages' plans agree on the CPU
too; at full FlyBase scale `das_tpu` on the CPU prices differently.
Repricing for Hopper's shared memory is later work."""

from __future__ import annotations

from dataclasses import dataclass

ROUTE_SINGLE = "single"
ROUTE_TILED = "tiled"
ROUTE_LOWERED = "lowered"

#: byte budget of one kernel's combined buffers: half of a TPU core's
#: ~16 MB VMEM (a pricing constant here, see the module docstring)
DEFAULT_VMEM_BUDGET = 8 * 1024 * 1024

#: per-grid-step streamed blocks target at most this fraction of the budget
_BLOCK_FRACTION = 4

#: rows axis granularity of a grid chunk (the (8, 128) tiling's minor axis)
LANE_ROWS = 128

#: floor for the chunk size
MIN_CHUNK_ROWS = 1024

#: ceiling on grid steps before a stage is priced as lowered
MAX_GRID_STEPS = 256


@dataclass(frozen=True)
class StagePlan:
    """One kernel stage's verdict under the byte model: route, grid chunk
    (ROUTE_TILED only) and the model's two byte components."""

    route: str
    chunk_rows: int
    resident_bytes: int
    block_bytes: int


def _lane_floor(n: int) -> int:
    return (int(n) // LANE_ROWS) * LANE_ROWS


def _lane_ceil(n: int) -> int:
    return -(-int(n) // LANE_ROWS) * LANE_ROWS


def chunk_rows_for(row_bytes: int, capacity: int, budget: int) -> int:
    """Grid step size: the largest lane-aligned chunk whose streamed block
    stays under budget / _BLOCK_FRACTION, floored at MIN_CHUNK_ROWS and
    never larger than the window rounded up to a lane multiple."""
    cap_aligned = _lane_ceil(max(int(capacity), 1))
    chunk = _lane_floor(budget // _BLOCK_FRACTION // max(row_bytes, 1))
    chunk = max(chunk, MIN_CHUNK_ROWS)
    return min(chunk, cap_aligned)


def _plan(resident: int, per_row: int, capacity: int) -> StagePlan:
    """Shared route pick: resident bytes + capacity x per_row vs budget."""
    capacity = max(int(capacity), 0)
    budget = DEFAULT_VMEM_BUDGET
    single = resident + per_row * capacity
    if single <= budget:
        return StagePlan(ROUTE_SINGLE, 0, resident, single - resident)
    if resident > budget:
        return StagePlan(ROUTE_LOWERED, 0, resident, per_row * capacity)
    chunk = chunk_rows_for(per_row, capacity, budget - resident)
    if resident + per_row * chunk > budget:
        return StagePlan(ROUTE_LOWERED, 0, resident, per_row * chunk)
    if -(-capacity // chunk) > MAX_GRID_STEPS:
        return StagePlan(ROUTE_LOWERED, 0, resident, per_row * chunk)
    return StagePlan(ROUTE_TILED, chunk, resident, per_row * chunk)


def probe_plan(n_keys: int, n_rows: int, arity: int, k_out: int,
               capacity: int) -> StagePlan:
    """Probe: the sorted posting keys, the permutation and the target
    table resident with the capacity window (single), or the window alone
    streamed per grid step (tiled)."""
    capacity = max(int(capacity), 0)
    per_row = 4 * arity + 4 * k_out + 12
    budget = DEFAULT_VMEM_BUDGET
    resident_single = 12 * int(n_keys) + 4 * int(n_rows) * arity
    single = resident_single + per_row * capacity
    if single <= budget:
        return StagePlan(ROUTE_SINGLE, 0, resident_single, single - resident_single)
    chunk = chunk_rows_for(per_row, capacity, budget)
    if per_row * chunk > budget or -(-capacity // max(chunk, 1)) > MAX_GRID_STEPS:
        return StagePlan(ROUTE_LOWERED, 0, 0, per_row * chunk)
    return StagePlan(ROUTE_TILED, chunk, 0, per_row * chunk)


def join_plan(n_left: int, k_left: int, n_right: int, k_right: int,
              n_pairs: int, k_out: int, capacity: int) -> StagePlan:
    """Sort-merge join: both tables and the sort/offset vectors resident;
    the output window tiles."""
    resident = (
        int(n_left) * (4 * k_left + 28)
        + int(n_right) * (4 * k_right + 24)
    )
    per_row = 4 * k_out + 4 * k_left + 4 * k_right + 16
    return _plan(resident, per_row, capacity)


def index_join_plan(n_left: int, k_left: int, n_keys: int, n_rows: int, arity: int,
                    k_out: int, capacity: int) -> StagePlan:
    """Index join: the left table and its probe and offset vectors
    resident (the posting index is searched, never held); the output
    window tiles."""
    resident = int(n_left) * (4 * k_left + 28)
    per_row = 4 * k_out + 4 * arity + 16
    return _plan(resident, per_row, capacity)


def multiway_plan(n_left: int, k_left: int, tails, k_out: int,
                  capacity: int) -> StagePlan:
    """k-way star join: the clause-0 table and every tail (at the padded
    width `tails` gives as (rows, width)) resident with their sort and
    search vectors; the output window tiles."""
    tails = tuple((int(r), int(w)) for r, w in tails)
    n_tails = max(len(tails), 1)
    resident = int(n_left) * (4 * k_left + 12 + 20 * n_tails)
    for rows, width in tails:
        resident += rows * (4 * width + 24)
    per_row = 4 * k_out + sum(4 * w for _r, w in tails) + 24
    return _plan(resident, per_row, capacity)


def anti_join_plan(n_left: int, k_left: int, n_right: int, k_right: int) -> StagePlan:
    """Anti join: both key columns resident; one bool out per left row, so
    single-block or lowered, never tiled."""
    resident = int(n_left) * (4 * k_left + 20) + int(n_right) * (4 * k_right + 20)
    return _plan(resident, 0, 0)
