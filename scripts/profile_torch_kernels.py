#!/usr/bin/env python3
"""Device time per CUDA kernel of das_tpu_torch's kernels on their
main-path inputs, by torch.profiler, on one NVIDIA card.

    python3 scripts/profile_torch_kernels.py [--scale S] [--calls N]

Builds the FlyBase-shaped store of chip_smoke.py at --scale, records the
inputs the executor gives each kernel (a grounded query and its Not
variant, a grounded star and a whole-type fan-out star), runs each call N
times under torch.profiler and prints, per call, one JSON line
{"call": ..., "regime": ..., "kernels_us_per_call": {name: device us}}.
The calls: the probe (the grounded query's probed terms in one call, one
of those terms alone, the whole-type window), the sort-merge join (its
main-path call in regime block, and a 4,096-row left side against 65,536
Member rows in regime global), the index join, the anti join and the
multiway join.
CUDA events around back-to-back calls (chip_smoke.py's `ms`) measure the
host's enqueue rate when it is slower than the card; this separates the
card's own time."""

from __future__ import annotations

import argparse
import json
import math
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
    terms = main_path["probe_terms"][0][0]
    t0 = terms[0]
    member = das.db.dev.buckets[2]
    tid_member = das.db._type_id("Member")
    n_member = int((das.db.fin.buckets[2].type_id == tid_member).sum())
    big_cap = 1 << max(21, math.ceil(math.log2(n_member)))
    procs = member.targets[: 1 << 16, 1:2].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(1234)
    left = torch.randint(int(procs.min()), int(procs.max()) + 1, (4096, 2), generator=gen,
                         dtype=torch.int32).cuda()
    lmask = torch.ones(4096, dtype=torch.bool, device="cuda")
    ones = torch.ones(procs.shape[0], dtype=torch.bool, device="cuda")
    calls = [
        (f"probe main path ({len(terms)} terms, one call)", "probe",
         lambda: kernels.probe_term_tables(terms)),
        ("probe one term", "probe",
         lambda: kernels.probe_term_table(*t0[:6], var_cols=t0.var_cols, eq_pairs=t0.eq_pairs,
                                          extra_fixed=t0.extra_fixed)),
        ("probe whole-type window", "probe",
         lambda: kernels.probe_term_table(member.key_type, member.order_by_type, member.targets,
                                          tid_member, [], big_cap, var_cols=(0, 1),
                                          eq_pairs=(), extra_fixed=())),
        ("join_tables main path", "join_tables",
         lambda: kernels.join_tables(*main_path["join_tables"][0])),
        ("join_tables global (left 4,096 x right 65,536)", "join_tables",
         lambda: kernels.join_tables(left, lmask, procs, ones, ((1, 0),), (0,), 4096)),
        ("index_join main path", None, lambda: kernels.index_join(*main_path["index_join"][0])),
        ("anti_join main path", "anti_join", lambda: kernels.anti_join(*main_path["anti_join"][0])),
        ("multiway grounded star", "multiway",
         lambda: kernels.multiway_join(*main_path["multiway"][0])),
        ("multiway whole-type fan-out star", "multiway",
         lambda: kernels.multiway_join(*main_path["multiway_whole_type"][0])),
    ]
    for label, name, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        per_kernel = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            # "aj_shared_kernel(int const*, ...)", "void (anonymous
            # namespace)::grp_hist_kernel<false, MwStarKeys>(...)"
            key = ev.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            kernel = key.split("(")[0].split("<")[0]
            if us > 0 and kernel.isidentifier():
                per_kernel[kernel] = per_kernel.get(kernel, 0) + us / args.calls
        print(json.dumps({"call": label, "regime": launch.LAST_REGIME.get(name),
                          "device_launches": launch.DEVICE_LAUNCHES.get(name),
                          "kernels_us_per_call": per_kernel,
                          "total_us_per_call": sum(per_kernel.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
