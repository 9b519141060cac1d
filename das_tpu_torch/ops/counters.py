"""Declared counter keys (own copies of the keys of
`das_tpu/ops/counters.py` ROUTE_KEYS and PLANNER_KEYS that the port has).

ROUTE_KEYS names the per-query answer routes the port counts
(`query/compiler.py ROUTE_COUNTS` is built from it); the planner predicts
one of them per plan (`PlannedProgram.route`, `PlannedTree.route`).  A
key joins in the slice that brings its route.  Counting sites:
query/compiler.py (the per-query router, and "star" in `count_matches`),
api/atomspace.py (the batched settle), query/fused.py (settled jobs,
`count_batch`) and mining/miner.py `count_many` ("star", per star lane).
PLANNER_KEYS is the planner's telemetry (`planner.PLANNER_COUNTS` is built
from it):

  planned / greedy          conjunctions ordered and seeded by the planner
                            vs the greedy heuristics (off, declined)
  dp / greedy_tail / ref_order  which search produced the planned order
  programs                  programs run for planned jobs (one per round)
  round0 / retries          planned jobs settled with no capacity retry /
                            retry rounds planned jobs still paid
  est_rows / actual_rows    summed estimated vs actual step output rows
  explain                   conjunctions planned by explain()"""

ROUTE_KEYS = (
    "fused",
    "fused_kernel",
    "fused_multiway",
    "fused_tree",
    "sharded_tree_fused",
    "staged",
    "tree",
    "sharded",
    "sharded_kernel",
    "sharded_multiway",
    "count_kernel",
    "host",
    "star",
)

PLANNER_KEYS = (
    "planned",
    "greedy",
    "dp",
    "greedy_tail",
    "ref_order",
    "programs",
    "round0",
    "retries",
    "est_rows",
    "actual_rows",
    "explain",
)
