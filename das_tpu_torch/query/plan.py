"""Generalized device query plans: And / Or / Not trees over ordered AND
unordered link patterns (port of `das_tpu/query/plan.py`).

The conjunctive compiler (query/compiler.py) covers conjunctions of
ordered patterns; this module plans the full logical language:

  PTerm   — ordered Link / LinkTemplate (reuses compiler.TermPlan)
  PUTerm  — unordered Link / LinkTemplate (multiset semantics)
  PAnd    — the reference And semantics incl. the empty-accumulator
            reseed quirk and negated-term forbidden sets
  POr     — the reference Or semantics incl. the joint-negative
            de-Morgan branch
  PNot    — negation wrapper
  PConst  — plan-time-decidable terms (grounded links, bare nodes):
            a static matched flag with no assignments

Execution lives in query/tree.py (staged) and the fused tree executor
(query/fused.py `build_fused_tree`).  Queries outside even this language
(e.g. Links nesting LinkTemplates) raise NotCompilable and run on the
host algebra.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from das_tpu_torch.core.hashing import ExpressionHasher, hex_to_i64
from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES
from das_tpu_torch.query.ast import (
    And,
    Link,
    LinkTemplate,
    LogicalExpression,
    Node,
    Not,
    Or,
    TypedVariable,
    Variable,
)
from das_tpu_torch.query.compiler import NotCompilable, TermPlan, UnknownAtom, _plan_term


@dataclass
class PUTermPlan:
    """An unordered link pattern: probe by multiset, values = the sorted
    remaining targets after removing the grounded multiset."""

    arity: int
    type_id: Optional[int]                 # None only for template probes
    required: Tuple[Tuple[int, int], ...]  # (global_row, count), sorted
    var_names: Tuple[str, ...]             # distinct pattern variables
    ctype: Optional[int] = None            # template probe key (int64)


@dataclass
class PTerm:
    plan: TermPlan


@dataclass
class PUTerm:
    plan: PUTermPlan


@dataclass
class PConst:
    matched: bool


@dataclass
class PNot:
    child: "PlanNode"


@dataclass
class PAnd:
    children: List["PlanNode"] = field(default_factory=list)


@dataclass
class POr:
    children: List["PlanNode"] = field(default_factory=list)


PlanNode = Union[PTerm, PUTerm, PConst, PNot, PAnd, POr]


def _plan_unordered_link(db, term: Link) -> Union[PUTerm, PConst]:
    if term.atom_type in db.data.pattern_black_list:
        raise NotCompilable("blacklisted link type")  # host algebra answers
    arity = len(term.targets)
    type_id = db._type_id(term.atom_type)
    if type_id is None:
        return PConst(False)  # unknown type: get_matched_links -> []
    var_names: List[str] = []
    grounded_counts = {}
    for target in term.targets:
        if isinstance(target, TypedVariable):
            raise NotCompilable("typed variable in unordered link")
        if isinstance(target, Variable):
            if target.name in var_names:
                # duplicate variable: UnorderedAssignment.assign rejects
                # every candidate -> no matches
                return PConst(False)
            var_names.append(target.name)
        elif isinstance(target, Node):
            handle = target.get_handle(db)
            row = db.fin.row_of_hex.get(handle) if handle else None
            if row is None:
                return PConst(False)  # Node.matched false -> Link.matched false
        else:
            raise NotCompilable("unsupported unordered target")
    if not var_names:
        # fully grounded: Link.matched degenerates to link_exists;
        # handles exist per the loop above
        handles = [t.get_handle(db) for t in term.targets]
        return PConst(db.link_exists(term.atom_type, handles))
    for target in term.targets:
        if isinstance(target, Node):
            row = db.fin.row_of_hex[target.get_handle(db)]
            grounded_counts[row] = grounded_counts.get(row, 0) + 1
    return PUTerm(
        PUTermPlan(
            arity=arity,
            type_id=type_id,
            required=tuple(sorted(grounded_counts.items())),
            var_names=tuple(var_names),
        )
    )


def _plan_unordered_template(db, term: LinkTemplate) -> Union[PUTerm, PConst]:
    names: List[str] = []
    for tv in term.targets:
        if not isinstance(tv, TypedVariable):
            raise NotCompilable("template target")
        if tv.name in names:
            return PConst(False)  # duplicate var: assign rejects all
        names.append(tv.name)
    type_hashes = [
        db.data.table.get_named_type_hash(t)
        for t in [term.link_type, *[tv.type for tv in term.targets]]
    ]
    ctype_hex = ExpressionHasher.composite_hash(type_hashes)
    return PUTerm(
        PUTermPlan(
            arity=len(term.targets),
            type_id=None,
            required=(),
            var_names=tuple(names),
            ctype=int(hex_to_i64(ctype_hex)),
        )
    )


def _plan_leaf(db, term) -> PlanNode:
    if isinstance(term, LinkTemplate):
        if term.ordered:
            return PTerm(_plan_term(db, term, False))
        return _plan_unordered_template(db, term)
    if isinstance(term, Link):
        if any(isinstance(t, LinkTemplate) for t in term.targets):
            raise NotCompilable("nested template link")
        # get_matched_links keys the probe mode off the TYPE NAME
        # (schema.UNORDERED_LINK_TYPES), the assignment class off
        # the ctor flag; compile only when the two agree.
        db_unordered = term.atom_type in UNORDERED_LINK_TYPES
        if term.ordered and db_unordered:
            raise NotCompilable("ordered pattern on unordered link type")
        if not term.ordered and not db_unordered:
            raise NotCompilable("unordered pattern on ordered link type")
        if not term.ordered:
            return _plan_unordered_link(db, term)
        has_var = any(
            isinstance(t, Variable) and not isinstance(t, TypedVariable)
            for t in term.targets
        )
        if not has_var:
            # fully grounded all-Node link: reference Link.matched
            # degenerates to node existence + link_exists; nested
            # grounded links recurse
            # through Link.matched and stay on the host
            if not all(isinstance(t, Node) for t in term.targets):
                raise NotCompilable("grounded link with non-node targets")
            handles = []
            for t in term.targets:
                if not db.node_exists(t.atom_type, t.name):
                    return PConst(False)
                handles.append(t.get_handle(db))
            return PConst(db.link_exists(term.atom_type, handles))
        try:
            return PTerm(_plan_term(db, term, False))
        except UnknownAtom:
            # unknown grounded node or unknown link type: the reference
            # answers no-match, not an error
            return PConst(False)
    if isinstance(term, Node):
        return PConst(db.node_exists(term.atom_type, term.name))
    if isinstance(term, Variable):  # includes TypedVariable
        return PConst(True)
    raise NotCompilable(f"unsupported leaf {type(term).__name__}")


def build_plan(db, query: LogicalExpression) -> PlanNode:
    """Plan an arbitrary And/Or/Not tree, or raise NotCompilable."""
    if isinstance(query, Not):
        return PNot(build_plan(db, query.term))
    if isinstance(query, And):
        return PAnd([build_plan(db, t) for t in query.terms])
    if isinstance(query, Or):
        return POr([build_plan(db, t) for t in query.terms])
    return _plan_leaf(db, query)
