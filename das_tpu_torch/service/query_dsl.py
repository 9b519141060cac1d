"""Postfix query DSL of the service edge (port of
`das_tpu/service/query_dsl.py`; it parses into the port's query/ast.py).

A comma-separated language: a prefix of ``Node`` bindings,
then ``Link`` terms pushing onto a stack, then postfix ``AND`` / ``OR``
(fold the whole stack) and ``NOT`` (pop one):

    Node n1 Concept human, Link Inheritance n1 $1, Link Similarity $1 $2, AND

Variables start with ``$``.  Unordered link types (Similarity, Set) get
``ordered=False`` automatically.  Returns None for malformed input — the
server maps that to an error Status, never an exception.
"""

from __future__ import annotations

from typing import Optional

from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES
from das_tpu_torch.query.ast import And, Link, LogicalExpression, Node, Not, Or, Variable


def parse_query(query_str: str) -> Optional[LogicalExpression]:
    nodes = {}
    stack = []
    reading_nodes = True
    for chunk in query_str.split(","):
        words = chunk.strip().split()
        if not words:
            return None
        head = words[0]
        if reading_nodes:
            if head == "Node":
                if len(words) != 4:
                    return None
                nodes[words[1]] = Node(words[2], words[3])
                continue
            reading_nodes = False
        if head == "Link":
            if len(words) < 3:
                return None
            link_type = words[1]
            targets = []
            for word in words[2:]:
                if word.startswith("$"):
                    targets.append(Variable(word))
                elif word in nodes:
                    targets.append(nodes[word])
                else:
                    return None
            stack.append(Link(link_type, targets, link_type not in UNORDERED_LINK_TYPES))
        elif head == "AND":
            if not stack:
                return None
            stack = [And(stack)]
        elif head == "OR":
            if not stack:
                return None
            stack = [Or(stack)]
        elif head == "NOT":
            if not stack:
                return None
            stack.append(Not(stack.pop()))
        else:
            return None
    if len(stack) != 1:
        return None
    return stack[0]
