#!/usr/bin/env python
"""Knowledge-base loader of the PyTorch port (the counterpart of
scripts/load_das.py).

Loads a MeTTa/Atomese knowledge base (a file or a directory of them) into
a store on the card, or on `--device cpu`, and optionally writes a
checkpoint directory that a later construction loads without parsing.

    python scripts/load_das_torch.py --knowledge-base data/samples/animals.metta \\
        --device cpu --checkpoint /tmp/animals_ckpt
    python scripts/load_das_torch.py --knowledge-base kb.metta --canonical

`--canonical` reads converter-format files through the native C++ scanner
(ingest/native.py), which is built on first use and raises when it cannot
be."""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run(argv=None) -> int:
    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    ap = argparse.ArgumentParser(description="Load a knowledge base")
    ap.add_argument("--knowledge-base", required=True,
                    help="path to a .metta/.scm file or directory of them")
    ap.add_argument("--canonical", action="store_true",
                    help="use the canonical loader (converter-format files)")
    ap.add_argument("--backend", default="tensor", choices=("memory", "tensor", "sharded"))
    ap.add_argument("--device", default=None,
                    help="torch device of the store (default: the CUDA card)")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint directory after loading")
    args = ap.parse_args(argv)

    das = DistributedAtomSpace(backend=args.backend, device=args.device)
    t0 = time.perf_counter()
    if args.canonical:
        das.load_canonical_knowledge_base(args.knowledge_base)
    else:
        das.load_knowledge_base(args.knowledge_base)
    nodes, links = das.count_atoms()
    print(f"Loaded {nodes} nodes, {links} links in {time.perf_counter()-t0:.2f}s")
    if args.checkpoint:
        t0 = time.perf_counter()
        das.save_checkpoint(args.checkpoint)
        print(f"Checkpoint written to {args.checkpoint} in {time.perf_counter()-t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
