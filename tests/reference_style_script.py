"""A script written as the reference's own scripts are: it imports only
the `das` package and calls `expr.matched(das.db, answer)` on the
expressions themselves.  tests/test_torch_compat.py runs it through both
shims (`PYTHONPATH=compat:.` for das_tpu, `PYTHONPATH=compat_torch:.` for
the PyTorch port) and compares the normalized outputs.

    python tests/reference_style_script.py <animals.metta>

Every printed line is either order-free or normalized by
scripts/regression_torch.py `normalize_regression_output`."""

import json
import os
import sys

from das.database.db_interface import WILDCARD
from das.distributed_atom_space import DistributedAtomSpace, QueryOutputFormat
from das.exceptions import MettaSyntaxError
from das.expression_hasher import ExpressionHasher, StringExpressionHasher
from das.pattern_matcher.pattern_matcher import (
    And,
    Link,
    LinkTemplate,
    Node,
    Not,
    Or,
    PatternMatchingAnswer,
    TypedVariable,
    Variable,
)


def match(das, expression):
    print(f"Matching {expression}")
    answer = PatternMatchingAnswer()
    print(expression.matched(das.db, answer))
    print(answer)
    print("-" * 80)


def C(name):
    return Node("Concept", name)


def main(kb):
    das = DistributedAtomSpace()
    das.load_knowledge_base(kb)
    print(list(das.count_atoms()))
    print(len(das._get_file_list(os.path.dirname(kb))))
    human = das.get_node("Concept", "human")
    print(human == ExpressionHasher.terminal_hash("Concept", "human"))
    print(StringExpressionHasher.terminal_hash("Concept", "human"))
    print(sorted(das.get_links("Inheritance", targets=[human, WILDCARD])))
    print(sorted(das.get_nodes("Concept")))
    print(json.dumps(das.get_atom(human, output_format=QueryOutputFormat.ATOM_INFO),
                     sort_keys=True))
    print("-" * 80)
    inh = lambda a, b: Link("Inheritance", [a, b], True)  # noqa: E731
    sim = lambda a, b: Link("Similarity", [a, b], False)  # noqa: E731
    V1, V2, V3 = Variable("V1"), Variable("V2"), Variable("V3")
    queries = [
        inh(C("human"), C("mammal")),
        sim(C("human"), C("monkey")),
        inh(V1, C("mammal")),
        inh(V1, V2),
        sim(C("human"), V1),
        Not(inh(V1, C("mammal"))),
        And([inh(V1, V2), inh(V2, V3)]),
        And([inh(V1, V3), inh(V2, V3), Not(sim(V1, V2))]),
        And([sim(C("human"), V1), Not(inh(V1, C("mammal")))]),
        Or([inh(V1, C("reptile")), inh(V1, C("plant"))]),
        Or([Not(inh(V1, V2)), sim(V1, V2)]),
        And([Link("Set", [V1, V2, V3, Variable("V4")], False), Not(Or([inh(V1, V2), sim(V1, V2)]))]),
        LinkTemplate("Inheritance", [TypedVariable("V1", "Concept"),
                                     TypedVariable("V2", "Concept")], True),
        And([LinkTemplate("Inheritance", [TypedVariable("V1", "Concept"),
                                          TypedVariable("V2", "Concept")], True),
             inh(V2, V3)]),
    ]
    for q in queries:
        match(das, q)
    tx = das.open_transaction()
    tx.add_toplevel_expression('(: "platypus" Concept)')
    tx.add_toplevel_expression('(Inheritance "platypus" "mammal")')
    das.commit_transaction(tx)
    print(list(das.count_atoms()))
    match(das, inh(V1, C("mammal")))
    match(das, And([inh(V1, C("mammal")), Not(sim(C("human"), V1))]))
    try:
        bad = das.open_transaction()
        bad.add_toplevel_expression('(Inheritance "platypus"')
        das.commit_transaction(bad)
        print("no error")
    except MettaSyntaxError:
        print("MettaSyntaxError")


if __name__ == "__main__":
    main(sys.argv[1])
