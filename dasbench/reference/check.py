"""The comparison that decides `correct`, and its control.

An answer of the service (`HANDLE` output) is the string of a set of
assignments, `{{'$V2': '<md5>', '$V3': '<md5>'}, ...}`, or "" when nothing
matched.  `parse` reads it into a set of index tuples in the family's
variable order; the reference works the same set out from the KB's
arrays.  The guarantee the configurations state is exact answers: every
binding the reference finds and no other.  Two numbers are compared:

* `wrong_answers`: checked requests whose answer is not the reference's
  set (an answer that binds a handle outside the KB, or other variables,
  is wrong too);
* `unanswered`: requests sent that got no answer or a failed status.

Both have the limit 0.  The control (`control_answer`) is the reference
itself computed over node ids narrowed to 16 bits, the step below the
program's 32-bit row ids: it binds the nodes of other genes whose ids
share the low bits, and fails `wrong_answers`.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Set, Tuple

import numpy as np

from dasbench.kb import KB, handle
from dasbench.reference.index import LinkIndex

LIMITS = {"wrong_answers": 0, "unanswered": 0}
#: the control's id width (check.py docstring)
CONTROL_BITS = 16

_ASSIGNMENT = re.compile(r"\{([^{}]*)\}")
_BINDING = re.compile(r"'([^']*)': '([0-9a-f]{32})'")


class HandleMap:
    """handle -> (node type, index) for every node of a KB."""

    def __init__(self, kb: KB):
        self.of: Dict[str, Tuple[str, int]] = {}
        for t, nodes in kb.nodes.items():
            for i in range(nodes.count):
                self.of[handle(t, nodes.name(i))] = (t, i)
        self._by_node = {node: h for h, node in self.of.items()}

    def handle(self, node_type: str, i: int) -> str:
        return self._by_node[(node_type, int(i))]


def parse(msg: str, variables, handles: HandleMap) -> Optional[Set[tuple]]:
    """The answer string as {((node type, index) per variable)}; None when
    it binds other variables or a handle that is no node of the KB."""
    if not msg:
        return set()
    pairs = _BINDING.findall(msg)
    k, n = len(variables), msg.count("{") - 1
    names = [v for v, _h in pairs[:k]]
    if n < 1 or len(pairs) != n * k or sorted(names) != sorted(variables) \
            or any(v != names[i % k] for i, (v, _h) in enumerate(pairs)):
        return _parse_each(msg, variables, handles)
    # every assignment names the variables in one order: map columns whole
    hs = [h for _v, h in pairs]
    cols = {v: list(map(handles.of.get, hs[j::k])) for j, v in enumerate(names)}
    if any(None in c for c in cols.values()):
        return None
    return set(zip(*(cols[v] for v in variables)))


def _parse_each(msg: str, variables, handles: HandleMap) -> Optional[Set[tuple]]:
    """`parse`, one assignment at a time (any order of the variables)."""
    out = set()
    for body in _ASSIGNMENT.findall(msg):
        binding = dict(_BINDING.findall(body))
        if sorted(binding) != sorted(variables):
            return None
        row = tuple(handles.of.get(binding[v]) for v in variables)
        if None in row:
            return None
        out.add(row)
    return out


def render(rows, variables, handles: HandleMap) -> str:
    """An answer set written as the service writes it (for the control)."""
    if not rows:
        return ""
    body = ", ".join("{" + ", ".join(f"'{v}': '{handles.handle(*node)}'"
                                     for v, node in zip(variables, row)) + "}"
                     for row in sorted(rows))
    return "{" + body + "}"


def control_answer(kb: KB, family, params, ix: Optional[LinkIndex] = None) -> set:
    """The control's answer: the reference over ids narrowed to
    CONTROL_BITS bits."""
    ix = ix or LinkIndex(kb, bits=CONTROL_BITS)
    return family.answer(ix, params)


def sample(statuses, rng: np.random.Generator, max_checked: int, longest: int):
    """Indices of the answered requests to check: all of them when there are
    at most `max_checked`, else the `longest` longest answers and a draw
    from the rest."""
    answered = [i for i, s in enumerate(statuses) if s is not None and s["success"]]
    if len(answered) <= max_checked:
        return answered
    by_len = sorted(answered, key=lambda i: -len(statuses[i]["msg"]))
    top = set(by_len[:longest])
    rest = np.asarray([i for i in answered if i not in top])
    drawn = rng.choice(rest, size=max_checked - len(top), replace=False).tolist()
    return sorted(top | set(drawn))


def check(kb: KB, families, requests, statuses, sent, checked, handles: HandleMap,
          ix: Optional[LinkIndex] = None) -> dict:
    """`requests[i]` = (family index, params), `statuses[i]` the service's
    status dict or None when no answer came; `sent` the indices sent,
    `checked` those to compare.  Returns the compared numbers, how many
    were checked, how many of those had a non-empty answer, and the first
    wrong one."""
    ix = ix or LinkIndex(kb)
    unanswered = sum(1 for i in sent if statuses[i] is None or not statuses[i]["success"])
    wrong, nonempty, first = [], 0, None
    for i in checked:
        fam_i, params = requests[i]
        family = families[fam_i]
        want = family.answer(ix, params)
        got = parse(statuses[i]["msg"], family.VARS, handles)
        nonempty += bool(want)
        if got != want:
            wrong.append(i)
            if first is None:
                first = {"request": i, "family": family.__name__.rsplit(".", 1)[-1],
                         "want": len(want), "got": None if got is None else len(got)}
    return {"wrong_answers": len(wrong), "unanswered": unanswered, "checked": len(checked),
            "nonempty": nonempty, "first_wrong": first, "wrong_idx": wrong}
