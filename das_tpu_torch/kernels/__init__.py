"""Hand-written Hopper kernels of the query path, and their wrappers.

Four kernels replace the four TPU kernels of `das_tpu/kernels/` that an
ordered conjunctive query runs:

  * `probe_term_table` — probe -> gather -> verify -> term table
    (csrc/probe.cu; das_tpu/kernels/probe.py);
  * `index_join` — join into a whole link type through its posting index
    (csrc/index_join.cu; das_tpu/kernels/join.py index_join_impl);
  * `join_tables` — sort-merge join of two materialized tables
    (csrc/join_tables.cu; join_tables_impl);
  * `anti_join` — the negation membership filter (csrc/anti_join.cu;
    anti_join_impl).

There is no routing switch: a CUDA tensor goes to the kernel (built at
first use, see launch.py) or the call raises; a CPU tensor goes to the
plain PyTorch version beside each wrapper."""

from das_tpu_torch.kernels.join import (  # noqa: F401
    anti_join,
    anti_join_plain,
    index_join,
    index_join_plain,
    join_tables,
    join_tables_plain,
)
from das_tpu_torch.kernels.launch import LAUNCH_COUNTS, reset_launch_counts  # noqa: F401
from das_tpu_torch.kernels.probe import (  # noqa: F401
    probe_term_table,
    probe_term_table_plain,
)
