"""The control of the comparison that decides `correct`.

    python3 dasbench/control.py --workload <cell> --seeds 11,12,13 [--requests N]

For each seed: the cell's KB and the requests a run draws from that seed,
answered by the control in the program's place (the reference over node
ids narrowed to 16 bits, `reference/check.py`), then held to the
reference by the same sample and comparison a run uses.  Prints one JSON
line per seed with `wrong_answers` beside its limit; the control has to
come out not correct.  It needs no card and loads nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dasbench import bio, run  # noqa: E402
from dasbench.reference import check as checker  # noqa: E402
from dasbench.reference.index import LinkIndex  # noqa: E402


def control_readings(workload: str, seed: int, n_requests: int = None,
                     config_overrides: dict = None, seconds: float = None) -> dict:
    spec = run.resolve(workload)
    bench = run.read_json(ROOT / "BENCHMARK.json")
    seconds = seconds or bench["run_seconds"]
    config = dict(spec.config, **(config_overrides or {}))
    t = time.perf_counter()
    kb = spec.generator.generate(config, seed)
    requests = run.draw(spec, kb, seed, int(math.ceil(spec.traffic["pool_per_second"] * seconds)),
                        stream=3)
    n = min(len(requests), n_requests or int(spec.traffic["check"]["max"]))
    handles = checker.HandleMap(kb)
    narrowed = LinkIndex(kb, bits=checker.CONTROL_BITS)
    statuses = [None] * len(requests)
    for i in range(n):
        f, p = requests[i]
        family = spec.families[f]
        rows = checker.control_answer(kb, family, p, narrowed)
        statuses[i] = {"success": True, "msg": checker.render(rows, family.VARS, handles)}
    chosen = checker.sample(statuses, bio.rng_for(seed, 5), int(spec.traffic["check"]["max"]),
                            int(spec.traffic["check"]["longest"]))
    result = checker.check(kb, spec.families, requests, statuses, list(range(n)), chosen,
                           handles, spec.ix)
    result.pop("wrong_idx")
    return dict(workload=workload, seed=seed, requests=n, seconds=time.perf_counter() - t,
                limit=checker.LIMITS["wrong_answers"], **result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(args.workload, seed, args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
