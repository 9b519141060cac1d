#!/usr/bin/env python
"""End-to-end query regression battery over the animals KB, on the
PyTorch port (das_tpu_torch).

The counterpart of scripts/regression.py: the SAME 48 + 7 match() calls in
the SAME order, the same three prints per match and the same separators,
with a --backend axis (memory | tensor | sharded), --device (default: the
CUDA card; `--device cpu` runs the plain PyTorch versions of the kernels)
and --shards for the sharded store.

    python scripts/regression_torch.py --backend tensor --device cpu
    python scripts/regression_torch.py --backend sharded --shards 8

The query list and the battery are importable (`first_section`,
`second_section`, `run(das)`; given the `das` shim's pattern_matcher
module, they build the queries from its routed classes and call
`expr.matched(das.db, answer)` as the reference's script does), and so
is the normalization that compares two outputs as 56 blocks (`normalize_regression_output`): set iteration
order and the uncommitted symbol/value pairing inside an
UnorderedAssignment's repr are not part of the answer.
`data/samples/regression_expected.txt` is scripts/regression.py's output on
the memory backend; tests/test_torch_regression.py regenerates it from
das_tpu on every run, so it cannot go stale.
"""

from __future__ import annotations

import argparse
import ast as pyast
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from das_tpu_torch.query import ast as _ast  # noqa: E402

#: scripts/regression.py --backend memory, as das_tpu prints it
EXPECTED = ROOT / "data" / "samples" / "regression_expected.txt"
#: the normalized battery has this many blocks: 48 matches, the node
#: lists between the sections, and 7 matches
N_BLOCKS = 56

HEADER = "---------------------------- Integration tests ---------------------------------"
RULE = "-" * 80
SEPARATOR = "\n\n\n\n" + "=" * 80 + "\n"


def first_section(m=_ast):
    """The 48 pre-separator queries, in scripts/regression.py's order,
    built from the expression classes of module `m`."""
    def N(name):
        return m.Node("Concept", name)

    def V(name):
        return m.Variable(name)

    Link, Not, And, Or = m.Link, m.Not, m.And, m.Or
    SET4 = lambda: Link("Set", [V("V1"), V("V2"), V("V3"), V("V4")], False)  # noqa: E731
    LIST4 = lambda: Link("List", [V("V1"), V("V2"), V("V3"), V("V4")], True)  # noqa: E731
    INH_V1V2 = lambda: Link("Inheritance", [V("V1"), V("V2")], True)  # noqa: E731
    SIM_V1V2 = lambda: Link("Similarity", [V("V1"), V("V2")], False)  # noqa: E731
    yield N("human")
    yield Link("Inheritance", [N("human"), N("mammal")], True)
    yield Link("Similarity", [N("human"), N("mammal")], False)
    yield Link("Similarity", [N("snake"), N("earthworm")], False)
    yield Link("Similarity", [N("earthworm"), N("snake")], False)
    # nested links over grounded sub-expressions
    l1 = Link("Inheritance", [N("dinosaur"), N("reptile")], True)
    l2 = Link("Inheritance", [N("triceratops"), N("dinosaur")], True)
    yield Link("List", [l1, l2], True)
    yield Link("List", [l2, l1], True)
    yield Link("Set", [l1, l2], False)
    yield Link("Set", [l2, l1], False)
    yield Link("Inheritance", [N("human"), N("mammal")], True)
    yield Link("Inheritance", [N("monkey"), N("mammal")], True)
    yield Link("Inheritance", [N("chimp"), N("mammal")], True)
    yield Link("Similarity", [N("human"), N("monkey")], False)
    yield Link("Similarity", [N("chimp"), N("monkey")], False)
    yield Link("Inheritance", [V("V1"), N("mammal")], True)
    yield Link("Inheritance", [V("V1"), V("V2")], True)
    yield Link("Inheritance", [V("V1"), V("V1")], True)
    yield Link("Inheritance", [V("V2"), V("V1")], True)
    yield Link("Inheritance", [N("mammal"), V("V1")], True)
    yield Link("Inheritance", [N("animal"), V("V1")], True)
    yield Link("Similarity", [V("V1"), V("V2")], False)
    yield Link("Similarity", [N("human"), V("V1")], False)
    yield Link("Similarity", [V("V1"), N("human")], False)
    yield Link("List", [N("human"), N("ent"), V("V1"), V("V2")], True)
    yield Link("List", [N("human"), V("V1"), V("V2"), N("ent")], True)
    yield Link("List", [N("ent"), V("V1"), V("V2"), N("human")], True)
    yield Link("Set", [N("human"), N("ent"), V("V1"), V("V2")], False)
    yield Link("Set", [N("human"), V("V1"), V("V2"), N("ent")], False)
    yield Link("Set", [N("ent"), V("V1"), V("V2"), N("human")], False)
    yield Link("Set", [N("monkey"), V("V1"), V("V2"), N("chimp")], False)
    yield INH_V1V2()
    yield Link("Inheritance", [V("V2"), V("V3")], True)
    yield Not(Link("Inheritance", [N("human"), N("mammal")], True))
    yield Not(Link("Inheritance", [V("V1"), N("mammal")], True))
    yield Not(Link("Inheritance", [V("V1"), N("human")], True))
    yield And([INH_V1V2(), Link("Inheritance", [V("V2"), V("V3")], True)])
    yield And([INH_V1V2(), SIM_V1V2()])
    yield And([
        Link("Inheritance", [V("V1"), V("V3")], True),
        Link("Inheritance", [V("V2"), V("V3")], True),
        SIM_V1V2(),
    ])
    yield And([
        Link("Inheritance", [V("V1"), V("V3")], True),
        Link("Inheritance", [V("V2"), V("V3")], True),
        Not(SIM_V1V2()),
    ])
    yield And([SET4(), SIM_V1V2()])
    yield And([SET4(), Not(SIM_V1V2())])
    yield And([SET4(), INH_V1V2()])
    yield And([SET4(), Not(INH_V1V2())])
    yield And([SET4(), Not(INH_V1V2()), SIM_V1V2()])
    yield Or([SET4(), SIM_V1V2()])
    yield Or([Not(INH_V1V2()), SET4()])
    yield And([SET4(), Not(Or([INH_V1V2(), SIM_V1V2()]))])
    yield And([
        Or([SET4(), LIST4()]),
        Not(Or([INH_V1V2(), SIM_V1V2()])),
    ])


def second_section(m=_ast):
    """The 7 post-separator queries, from the classes of module `m`."""
    def N(name):
        return m.Node("Concept", name)

    def V(name):
        return m.Variable(name)

    def TV(name):
        return m.TypedVariable(name, "Concept")

    yield m.LinkTemplate("Inheritance", [TV("V1"), TV("V2")], True)
    yield m.LinkTemplate("Similarity", [TV("V1"), TV("V2")], False)
    yield m.Link("Inheritance", [V("V1"), V("V2")], True)
    yield m.Link("List", [V("V1"), V("V2")], True)
    yield m.LinkTemplate("List", [TV("V1"), TV("V2")], True)
    yield m.Link("Similarity", [N("human"), V("V1")], False)
    yield m.Link("Similarity", [V("V1"), N("human")], False)


def match(das, expression, lines, reference_style=False) -> None:
    """One match(): the expression, the verdict, the answer.  The verdict
    comes from the facade's router, or with `reference_style` from
    `expression.matched(das.db, answer)`, as the reference's script calls
    it (the `das` shim's classes route that call themselves)."""
    lines.append(f"Matching {expression}")
    answer = _ast.PatternMatchingAnswer()
    if reference_style:
        verdict = expression.matched(das.db, answer)
    else:
        verdict = das._dispatch_query(expression, answer)
    lines.append(str(verdict))
    lines.append(str(answer))
    lines.append(RULE)


def run(das, m=None) -> str:
    """The whole battery against a facade that holds the animals KB; the
    text scripts/regression.py prints (without its trailing newline).
    With `m`, a module of expression classes (the `das` shim's
    pattern_matcher), the queries are built from it and called in the
    reference's style."""
    ref = m is not None
    m = m or _ast
    lines = [HEADER]
    for query in first_section(m):
        match(das, query, lines, ref)
    lines.append(SEPARATOR)
    lines.append(str(das.db.get_all_nodes("Concept")))
    lines.append(str(das.db.get_all_nodes("blah")))
    for query in second_section(m):
        match(das, query, lines, ref)
    return "\n".join(lines)


def animals_das(backend: str, device=None, shards: int = 8):
    """A facade over the animals KB on `backend`."""
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.animals import animals_metta

    config = DasConfig(mesh_shape=(shards,)) if backend == "sharded" else DasConfig()
    das = DistributedAtomSpace(backend=backend, config=config, device=device)
    das.load_metta_text(animals_metta())
    return das


# -- output normalization ----------------------------------------------------


def _canon_unord(d):
    # an UnorderedAssignment commits to no pairing: equal symbol and value
    # multisets are the same assignment
    return tuple(sorted(d.keys())), tuple(sorted(d.values()))


def _canon_line(line):
    line = line.strip()
    if not line:
        return None
    m = re.match(r"Ordered = (.*) \| Unordered = \[(.*)\]$", line)
    if m:
        o = m.group(1)
        od = None if o == "None" else tuple(sorted(pyast.literal_eval(o).items()))
        parts = re.findall(r"\*(\{[^}]*\})", m.group(2))
        uns = tuple(sorted(_canon_unord(pyast.literal_eval(p)) for p in parts))
        return ("comp", od, uns)
    if line.startswith("*{"):
        return ("unord", _canon_unord(pyast.literal_eval(line[1:])))
    if line.startswith("{"):
        return ("ord", tuple(sorted(pyast.literal_eval(line).items())))
    if line.startswith("["):  # a get_all_nodes handle list: order-free
        return ("list", tuple(sorted(pyast.literal_eval(line))))
    return ("raw", line)


def normalize_regression_output(text):
    """The battery's output as blocks of (header, sorted canonical lines)."""
    blocks, cur = [], []
    for line in text.splitlines():
        if line.startswith("-----") or line.startswith("====="):
            if cur:
                blocks.append(cur)
                cur = []
            continue
        if line.startswith("Matching"):
            if cur:
                blocks.append(cur)
            cur = [("hdr", line.strip())]
            continue
        c = _canon_line(line)
        if c:
            cur.append(c)
    if cur:
        blocks.append(cur)
    return [
        (
            tuple(x for x in b if x[0] == "hdr"),
            tuple(sorted(repr(x) for x in b if x[0] != "hdr")),
        )
        for b in blocks
    ]


def differing_blocks(text, want_text):
    """Indices of the normalized blocks where `text` and `want_text`
    differ (a length mismatch lists the missing indices too)."""
    got, want = normalize_regression_output(text), normalize_regression_output(want_text)
    n = max(len(got), len(want))
    return [i for i in range(n)
            if i >= len(got) or i >= len(want) or got[i] != want[i]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="animals KB query regression (PyTorch port)")
    ap.add_argument("--backend", default="memory", choices=("memory", "tensor", "sharded"))
    ap.add_argument("--device", default=None,
                    help="torch device of the tensor and sharded stores (default: CUDA)")
    ap.add_argument("--shards", type=int, default=8, help="slabs of the sharded store")
    args = ap.parse_args(argv)
    das = animals_das(args.backend, args.device, args.shards)
    print(run(das))
    das.clear_database()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
