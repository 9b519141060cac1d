#!/usr/bin/env python
"""Timed queries over a bio-shaped KB on the PyTorch port: the three
queries of examples/query_flybase.py, each cold and warm, on the tensor
store on the card (or `--device cpu`).  The synthetic bio atomspace
(das_tpu_torch/models/bio.py) stands in for the FlyBase dump, which is
not redistributable; `--genes` sets its size (processes, interactions and
evaluations scale with it), or pass a canonical .metta file from the
FlyBase converter.

Run:  python examples/query_flybase_torch.py [flybase.metta] [--genes 2000] [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from das_tpu_torch.api.atomspace import DistributedAtomSpace  # noqa: E402
from das_tpu_torch.models.bio import build_bio_atomspace  # noqa: E402
from das_tpu_torch.query.ast import And, Link, Variable  # noqa: E402
from das_tpu_torch.utils.timing import Clock  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?", default=None, help="canonical .metta file")
    ap.add_argument("--genes", type=int, default=2000, help="genes of the synthetic KB")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.source:
        das = DistributedAtomSpace(backend="tensor", device=args.device)
        das.load_canonical_knowledge_base(args.source)
    else:
        g = args.genes
        data, _genes, _ = build_bio_atomspace(
            n_genes=g, n_processes=max(1, g // 10), members_per_gene=5,
            n_interactions=g * 3 // 4, n_evaluations=g // 4)
        das = DistributedAtomSpace(backend="tensor", data=data, device=args.device)
    nodes, links = das.count_atoms()
    print(f"KB: {nodes} nodes, {links} links")

    clock = Clock()
    queries = {
        "Member($gene, $process)": Link("Member", [Variable("gene"), Variable("process")], True),
        "two genes in one process": And([
            Link("Member", [Variable("g1"), Variable("p")], True),
            Link("Member", [Variable("g2"), Variable("p")], True),
        ]),
        "co-process + interaction": And([
            Link("Member", [Variable("g1"), Variable("p")], True),
            Link("Member", [Variable("g2"), Variable("p")], True),
            Link("Interacts", [Variable("g1"), Variable("g2")], True),
        ]),
    }
    for title, query in queries.items():
        clock.start()
        matched, answer = das.query_answer(query)
        elapsed_ms = clock.elapsed() * 1e3
        print(f"{title}: {len(answer.assignments)} assignments in {elapsed_ms:.1f} ms")
        t0 = time.perf_counter()
        das.query_answer(query)
        print(f"  warm repeat: {(time.perf_counter() - t0) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
