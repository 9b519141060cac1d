#!/usr/bin/env python3
"""Device time per CUDA kernel of das_tpu_torch's anti join and multiway
join on their main-path inputs, by torch.profiler, on one NVIDIA card.

    python3 scripts/profile_torch_kernels.py [--scale S] [--calls N]

Builds the FlyBase-shaped store of chip_smoke.py at --scale, records the
inputs the executor gives the anti join (a grounded Not query) and the
multiway join (a grounded star and a whole-type fan-out star), runs each
call N times under torch.profiler and prints, per call, one JSON line
{"call": ..., "regime": ..., "kernels": {name: device us per call}}.
CUDA events around back-to-back calls (chip_smoke.py's `ms`) measure the
host's enqueue rate when it is slower than the card; this separates the
card's own time."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from das_tpu_torch import kernels
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.kernels import launch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    data, genes = cs.build_kb(cs.scaled(cs.FLYBASE, args.scale), 0)
    das = DistributedAtomSpace(backend="tensor", data=data, device="cuda")
    host = cs.HostKB(data, genes)
    gene = cs.pick_genes(host, [data.nodes[h].name for h in genes], 0, n=1, n_nonempty=1)[0]
    fam = cs.star_families(types.SimpleNamespace(seed=0), data, genes, host, das)
    main_path = cs.main_path_inputs(das, gene, fam["grounded_star"][0][0],
                                    fam["fanout_star"][0][0])
    calls = [("anti_join main path", "anti_join", kernels.anti_join, main_path["anti_join"][0]),
             ("multiway grounded star", "multiway", kernels.multiway_join,
              main_path["multiway"][0]),
             ("multiway whole-type fan-out star", "multiway", kernels.multiway_join,
              main_path["multiway_whole_type"][0])]
    for label, name, fn, fargs in calls:
        for _ in range(3):
            fn(*fargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn(*fargs)
            torch.cuda.synchronize()
        per_kernel = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            # "aj_shared_kernel(int const*, ...)", "void mw_hist_kernel<false>(...)"
            kernel = ev.key.split("(")[0].removeprefix("void ").split("<")[0]
            if us > 0 and kernel.isidentifier():
                per_kernel[kernel] = per_kernel.get(kernel, 0) + us / args.calls
        print(json.dumps({"call": label, "regime": launch.LAST_REGIME[name],
                          "device_launches": launch.DEVICE_LAUNCHES[name],
                          "kernels_us_per_call": per_kernel,
                          "total_us_per_call": sum(per_kernel.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
