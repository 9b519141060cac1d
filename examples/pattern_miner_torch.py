#!/usr/bin/env python
"""Frequent-subgraph mining on the PyTorch port: halo expansion around
seed genes, wildcard candidate patterns with support counts, stochastic
I-Surprisingness mining (examples/pattern_miner.py), over the tensor store
on the card (or `--device cpu`).  `--genes` sets the synthetic bio KB's
size.

Run:  python examples/pattern_miner_torch.py [--genes 500] [--epochs 200] [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from das_tpu_torch.api.atomspace import DistributedAtomSpace  # noqa: E402
from das_tpu_torch.mining.miner import PatternMiner  # noqa: E402
from das_tpu_torch.models.bio import build_bio_atomspace  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genes", type=int, default=500, help="genes of the synthetic KB")
    ap.add_argument("--epochs", type=int, default=200, help="mining epochs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    g = args.genes
    data, genes, _ = build_bio_atomspace(
        n_genes=g, n_processes=max(1, g // 10), members_per_gene=5,
        n_interactions=g * 4 // 5, n_evaluations=g // 5)
    das = DistributedAtomSpace(backend="tensor", data=data, device=args.device)
    nodes, links = das.count_atoms()
    print(f"KB: {nodes} nodes, {links} links")

    miner = PatternMiner(das.db, halo_length=2, link_rate=0.05, support=2, seed=7)

    t0 = time.perf_counter()
    universe = miner.expand_halo(genes[:20])
    print(f"halo: {universe} links in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    n_candidates = miner.build_patterns()
    print(f"candidates: {n_candidates} in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    best = miner.mine(ngram=2, epochs=args.epochs)
    print(f"mined in {time.perf_counter() - t0:.2f}s")
    if best:
        print("best pattern:", best.pattern)
        print("count:", best.count, " isurprisingness:", round(best.isurprisingness, 4))


if __name__ == "__main__":
    main()
