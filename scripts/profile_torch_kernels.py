#!/usr/bin/env python3
"""Device time per CUDA kernel of das_tpu_torch's kernels on their
main-path inputs, by torch.profiler, on one NVIDIA card.

    python3 scripts/profile_torch_kernels.py [--scale S] [--calls N] [--sweep]

Builds the FlyBase-shaped store of chip_smoke.py at --scale, records the
inputs the executor gives each kernel (a grounded query and its Not
variant, a grounded star and a whole-type fan-out star), runs each call N
times under torch.profiler and prints, per call, one JSON line
{"call": ..., "regime": ..., "kernels_us_per_call": {name: device us},
"events": {name: kernel events recorded}}.
The calls: the probe (the grounded query's probed terms in one call, one
of those terms alone, the whole-type window), the sort-merge join (its
main-path call in regime block, and a 4,096-row left side against 65,536
Member rows in regime global), the index join (its main-path call in
regime block, and 65,536 Member process ids joined into the main path's
posting index at cap 65,536 in regime global), the anti join and the
multiway join.  --sweep adds index joins of 0 to 4,096 process ids at
caps 2,048 to 16,385 (around the block regime's limits), each in the
regime the C entry picks.
A call whose profile records no kernel event, or a number of events of
some kernel that is not a multiple of N (events lost), is profiled again,
and after three such windows the script fails naming the call.
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
    ap.add_argument("--sweep", action="store_true",
                    help="also profile index joins of 16 to 4,096 left rows at cap 4,096")
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
    iargs = main_path["index_join"][0]
    rc_key = iargs[6][0][1]
    rc_other = next(rc for rc in range(len(iargs[7])) if rc != rc_key)
    fin_b = das.db.fin.buckets[2]
    mem_procs = torch.from_numpy(
        fin_b.targets[fin_b.type_id == tid_member][: 1 << 16, 1:2].copy()).cuda()
    mem_ones = torch.ones(mem_procs.shape[0], dtype=torch.bool, device="cuda")

    def index_join_of(n, cap):
        return lambda: kernels.index_join(mem_procs[:n], mem_ones[:n], *iargs[2:6],
                                          ((0, rc_key),), iargs[7], (rc_other,), cap)

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
        ("index_join main path", "index_join", lambda: kernels.index_join(*iargs)),
        ("index_join global (65,536 process ids, cap 65,536)", "index_join",
         index_join_of(1 << 16, 1 << 16)),
        ("anti_join main path", "anti_join", lambda: kernels.anti_join(*main_path["anti_join"][0])),
        ("multiway grounded star", "multiway",
         lambda: kernels.multiway_join(*main_path["multiway"][0])),
        ("multiway whole-type fan-out star", "multiway",
         lambda: kernels.multiway_join(*main_path["multiway_whole_type"][0])),
    ]
    if args.sweep:
        calls += [(f"index_join sweep: {n} process ids, cap {cap:,}", "index_join",
                   index_join_of(n, cap))
                  for n, cap in [(0, 2048), (16, 2048), (32, 4096), (129, 4096), (256, 4096),
                                 (512, 4096), (1024, 4096), (4096, 4096)]
                  + [(n, cap) for n in (16, 64, 128) for cap in (4096, 8192, 16384, 16385)]]
    for label, name, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _attempt in range(3):
            per_kernel, events = profile_call(fn, args.calls, profile, ProfilerActivity)
            if events and all(n % args.calls == 0 for n in events.values()):
                break
        else:
            raise SystemExit(f"profile_torch_kernels: [{label}] recorded "
                             f"{'no kernel events' if not events else 'lost events'}: {events}")
        print(json.dumps({"call": label, "regime": launch.LAST_REGIME.get(name),
                          "device_launches": launch.DEVICE_LAUNCHES.get(name),
                          "kernels_us_per_call": per_kernel, "events": events,
                          "total_us_per_call": sum(per_kernel.values())}), flush=True)
    return 0


def profile_call(fn, calls, profile, activities):
    """({kernel: device us per call}, {kernel: events}) of `calls` calls of
    fn under torch.profiler."""
    import torch

    with profile(activities=[activities.CPU, activities.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel, events = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        # "aj_shared_kernel(int const*, ...)", "void (anonymous
        # namespace)::grp_hist_kernel<false, MwStarKeys>(...)"
        key = ev.key.removeprefix("void ").replace("(anonymous namespace)::", "")
        kernel = key.split("(")[0].split("<")[0]
        if us > 0 and kernel.isidentifier():
            per_kernel[kernel] = per_kernel.get(kernel, 0) + us / calls
            events[kernel] = events.get(kernel, 0) + ev.count
    return per_kernel, events


if __name__ == "__main__":
    sys.exit(main())
