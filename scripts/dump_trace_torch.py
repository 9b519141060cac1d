#!/usr/bin/env python
"""Render a traced, served workload of the PyTorch port as Perfetto-loadable
Chrome trace-event JSON (the counterpart of scripts/dump_trace.py).

Two modes:

  * demo (default): build a small bio KB on the card (or `--device cpu`),
    switch tracing and the program ledger on (`obs.configure(enabled=True)`,
    `proflog.configure(enabled=True)`), serve a 3-variable conjunctive
    query and grounded ones through a tenant's coalescer, serve them again
    (result-cache hits), commit once (the cache's invalidation) and serve
    again, then write the trace: submit -> drain -> group -> plan ->
    dispatch -> settle -> answer spans with their attributes, one lane per
    tenant and worker, and a "compile" lane with the ledger's first calls.
    With the store on a card the demo runs under `torch.profiler`, and the
    output is one file on one clock: the profiler's trace with the spans
    merged in, shifted onto its clock by a marker kernel
    (obs/torchprof.py `merge_recorder`), so the worker's spans lie over
    the CUDA stream that their launches fed.

        python scripts/dump_trace_torch.py -o das_trace.json --device cpu

  * `--self`: no workload; dump what this process's recorder holds
    (`dump_current(path)`, for embedding in a service).

Open the output at https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def dump_current(path: str) -> str:
    """Write the current process recorder's ring to `path`."""
    from das_tpu_torch import obs

    return obs.dump_chrome_trace(obs.events(), path)


def demo_workload(n_clients: int, scale: float, device=None, profile_dir=None):
    """Serve the demo workload with tracing on; the trace stays in the
    process recorder.  With the store on a card and a `profile_dir`, the
    workload runs under torch.profiler and the merged trace file's path
    is returned; else None."""
    from das_tpu_torch import obs
    from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.query.ast import And, Link, Node, Variable
    from das_tpu_torch.service.coalesce import QueryCoalescer
    from das_tpu_torch.service.server import _Tenant

    obs.configure(enabled=True)
    obs.reset()
    # the program ledger's first calls land as prof.compile spans in their
    # own "compile" lane, beside the serving lanes they stall
    obs.proflog.configure(enabled=True)
    obs.proflog.reset()

    data, genes, _procs = build_bio_atomspace(
        n_genes=max(64, int(1000 * scale)),
        n_processes=max(16, int(200 * scale)),
        members_per_gene=5,
        n_interactions=max(128, int(2000 * scale)),
    )
    das = DistributedAtomSpace(database_name="trace-demo", data=data, device=device)
    on_card = profile_dir is not None and das.db.device.type == "cuda"
    if on_card:
        obs.maybe_start_trace(SimpleNamespace(profiler_trace_dir=profile_dir))
    tenant = _Tenant("trace-demo", das)
    coal = QueryCoalescer()

    three_var = And([
        Link("Member", [Variable("V1"), Variable("V3")], True),
        Link("Member", [Variable("V2"), Variable("V3")], True),
        Link("Interacts", [Variable("V1"), Variable("V2")], True),
    ])

    def grounded(g):
        name = das.get_node_name(g)
        return And([
            Link("Member", [Node("Gene", name), Variable("V3")], True),
            Link("Member", [Variable("V2"), Variable("V3")], True),
            Link("Interacts", [Node("Gene", name), Variable("V2")], True),
        ])

    def serve(queries):
        futs = [coal.submit(tenant, q, QueryOutputFormat.HANDLE) for q in queries]
        for f in futs:
            f.result(timeout=600)

    workload = [three_var] + [grounded(genes[i % 8]) for i in range(n_clients - 1)]
    serve(workload)
    # the same workload again: result-cache hits (cache.hit, no dispatch)
    serve(workload)
    # one incremental commit: commit.delta and cache.invalidate
    das.load_metta_text('(: "GENE:TRACE" Gene)\n(: "GO:TRACE" BiologicalProcess)\n'
                        '(Member "GENE:TRACE" "GO:TRACE")')
    serve([workload[1]] * 2)
    time.sleep(0.1)  # let the worker's settle span land in the ring
    if on_card and obs.maybe_stop_trace():
        return obs.torchprof.last_trace_path()
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--out", default="das_trace.json")
    ap.add_argument("--self", action="store_true", dest="self_only",
                    help="dump the current recorder ring; run no demo workload")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--scale", type=float, default=0.1, help="bio KB size factor")
    ap.add_argument("--device", default=None,
                    help="torch device of the store (default: the CUDA card)")
    args = ap.parse_args(argv)
    merged = None
    if not args.self_only:
        profile_dir = tempfile.mkdtemp(prefix="das_trace_")
        try:
            merged = demo_workload(args.clients, args.scale, args.device, profile_dir)
            if merged is not None:
                shutil.move(merged, args.out)
        finally:
            shutil.rmtree(profile_dir, ignore_errors=True)
    path = args.out if merged is not None else dump_current(args.out)
    with open(path) as f:
        n = len(json.load(f)["traceEvents"])
    print(f"wrote {n} trace events to {path}; open it in ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
