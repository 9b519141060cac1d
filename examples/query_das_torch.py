#!/usr/bin/env python
"""Pattern-matching queries over the animals KB on the PyTorch port: the
same four And/Not/Or queries as examples/query_das.py, on the tensor store
on the card (or `--device cpu`).

Run:  python examples/query_das_torch.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from das_tpu_torch.api.atomspace import DistributedAtomSpace  # noqa: E402
from das_tpu_torch.models.animals import animals_metta  # noqa: E402
from das_tpu_torch.query.ast import And, Link, Node, Not, Or, Variable  # noqa: E402


def show(das, title, query):
    print(f"\n== {title}")
    matched, answer = das.query_answer(query)
    if not matched:
        print("  no match")
        return
    for assignment in sorted(answer.assignments, key=repr):
        print("  ", assignment)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    das = DistributedAtomSpace(backend="tensor", device=args.device)
    das.load_metta_text(animals_metta())

    # 1. What inherits from mammal?
    show(das, "Inheritance($V1, mammal)",
         Link("Inheritance", [Variable("V1"), Node("Concept", "mammal")], True))

    # 2. Similar to human AND an Inheritance exists for the same V1
    show(das, "And(Similarity(human, $V1), Inheritance($V1, $V2))", And([
        Link("Similarity", [Node("Concept", "human"), Variable("V1")], False),
        Link("Inheritance", [Variable("V1"), Variable("V2")], True),
    ]))

    # 3. Similar to human but NOT a mammal
    show(das, "And(Similarity(human, $V1), Not(Inheritance($V1, mammal)))", And([
        Link("Similarity", [Node("Concept", "human"), Variable("V1")], False),
        Not(Link("Inheritance", [Variable("V1"), Node("Concept", "mammal")], True)),
    ]))

    # 4. Inherits from reptile OR from plant
    show(das, "Or(Inheritance($V1, reptile), Inheritance($V1, plant))", Or([
        Link("Inheritance", [Variable("V1"), Node("Concept", "reptile")], True),
        Link("Inheritance", [Variable("V1"), Node("Concept", "plant")], True),
    ]))


if __name__ == "__main__":
    main()
