#!/usr/bin/env python
"""Load a MeTTa knowledge base and inspect it, on the PyTorch port: the
walk of examples/load_knowledge_base.py (atom counts, lookups by handle and
by name) over the tensor store on the card (or `--device cpu`).

Run:  python examples/load_knowledge_base_torch.py [path/to/kb.metta] [--device cpu]
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?", default=str(ROOT / "data/samples/animals.metta"))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    das = DistributedAtomSpace(backend="tensor", device=args.device)
    das.load_knowledge_base(args.source)

    nodes, links = das.count_atoms()
    print(f"loaded {args.source}: {nodes} nodes, {links} links")

    human = das.get_node("Concept", "human")
    print("Concept:human handle =", human)
    print("as dict =", das.get_atom(human, output_format=QueryOutputFormat.ATOM_INFO))

    print("\nall Inheritance links:")
    for link in das.get_links("Inheritance", output_format=QueryOutputFormat.ATOM_INFO):
        print(" ", link)

    print("\nnodes named like 'mon':")
    for handle in das.get_nodes("Concept", output_format=QueryOutputFormat.HANDLE):
        name = das.get_node_name(handle)
        if "mon" in name:
            print(" ", handle, name)


if __name__ == "__main__":
    main()
