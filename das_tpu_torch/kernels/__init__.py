"""Hand-written Hopper kernels of the query path, and their wrappers.

Five kernels replace the five TPU kernels of `das_tpu/kernels/` that an
ordered conjunctive query runs:

  * `probe_term_tables` — probe -> gather -> verify -> term table, every
    term of a plan in one launch; `probe_term_table` is its one-term call
    (csrc/probe.cu; das_tpu/kernels/probe.py);
  * `index_join` — join into a whole link type through its posting index
    (csrc/index_join.cu; das_tpu/kernels/join.py index_join_impl);
  * `join_tables` — the sort-merge join of two materialized tables, here
    a stable grouping by key with no sort (csrc/join_tables.cu on
    csrc/group.cuh; join_tables_impl);
  * `anti_join` — the negation membership filter (csrc/anti_join.cu;
    anti_join_impl);
  * `multiway_join` — the k-way star join the planner routes star
    prefixes to (csrc/multiway.cu; das_tpu/kernels/multiway.py
    multiway_join_impl).

There is no routing switch: a CUDA tensor goes to the kernel (built at
first use, see launch.py) or the call raises; a CPU tensor goes to the
plain PyTorch version beside each wrapper.  Every C entry reports the CUDA
design (regime) it ran by name, picked from the shapes alone where there
are several (the index, sort-merge, anti and multiway joins), counted in
`launch.REGIME_COUNTS`."""

from das_tpu_torch.kernels.join import (  # noqa: F401
    anti_join,
    anti_join_plain,
    index_join,
    index_join_plain,
    join_tables,
    join_tables_plain,
)
from das_tpu_torch.kernels.launch import LAUNCH_COUNTS, reset_launch_counts  # noqa: F401
from das_tpu_torch.kernels.multiway import multiway_join, multiway_join_plain  # noqa: F401
from das_tpu_torch.kernels.probe import (  # noqa: F401
    ProbeTerm,
    probe_term_table,
    probe_term_table_plain,
    probe_term_tables,
    probe_term_tables_plain,
)
