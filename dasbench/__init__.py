"""The benchmark of das_tpu_torch: `python3 dasbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` (see run.py)."""
