#!/usr/bin/env python3
"""Where a query's time goes on the sharded store, by torch.profiler, on one
NVIDIA card.

    python3 scripts/profile_torch_sharded.py [--scale S] [--shards N] [--queries Q]

Builds chip_smoke.py's FlyBase-shaped KB at --scale in a tensor store and
in a sharded store of N slabs on the card, warms each family up on both,
then runs Q queries of each family on each store under torch.profiler and
prints one JSON line per (store, family): host ms per query (the wall of
the window over Q), the card's busy ms per query (the sum of the card's
own kernel, copy and set events, each counted once), the host's self time
per query of the top operators, and the top CUDA kernels by device time.  The families are chip_smoke.py
phase sharded's grounded, Not, grounded-star and template-join queries."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _window(torch, profile, activities, fn, n_queries: int):
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # only the card's own events (kernels, copies, sets): an operator on the
    # host carries its kernels' device time too, and would count it twice
    card = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in card)
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    cuda = sorted(card, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {
        "host_ms_per_query": wall * 1e3 / n_queries,
        "card_busy_ms_per_query": device_us / 1e3 / n_queries,
        "host_self_ms_per_query": {e.key: e.self_cpu_time_total / 1e3 / n_queries for e in host},
        "host_calls_per_query": {e.key: e.count / n_queries for e in host},
        "device_ms_per_query": {e.key: e.self_device_time_total / 1e3 / n_queries for e in cuda},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--queries", type=int, default=8)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_sharded: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig

    card = cs.phase_card()
    data, genes = cs.build_kb(cs.scaled(cs.FLYBASE, args.scale), 0)
    stores = {
        "tensor": DistributedAtomSpace(backend="tensor", data=data, device="cuda"),
        "sharded": DistributedAtomSpace(backend="sharded", data=data, device="cuda:0",
                                        config=DasConfig(mesh_shape=(args.shards,))),
    }
    host = cs.HostKB(data, genes)
    names = cs.pick_genes(host, [data.nodes[h].name for h in genes], 1,
                          n=2 * args.queries, n_nonempty=args.queries)
    fams = cs.star_families(argparse.Namespace(seed=0), data, genes, host, stores["tensor"])
    families = {
        "grounded": [cs.grounded_query(g) for g in names],
        "not": [cs.grounded_query(g, True) for g in names],
        "grounded_star": [q for q, _n, _w in fams["grounded_star"][:2 * args.queries]],
        "template_join": [cs.template_join_query(g) for g in names],
    }
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for family, queries in families.items():
        warm, timed = queries[: args.queries], queries[args.queries: 2 * args.queries]
        for store, das in stores.items():
            for q in warm:
                das.query_answer(q)

            def run(das=das, timed=timed):
                for q in timed:
                    das.query_answer(q)

            line = {"store": store, "family": family, "queries": len(timed), "card": card}
            line.update(_window(torch, profile, activities, run, len(timed)))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
