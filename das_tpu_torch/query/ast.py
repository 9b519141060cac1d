"""Pattern-matching query AST and host evaluator.

Same logical language as the reference query engine
(reference das/pattern_matcher/pattern_matcher.py:370-748):
`Node`, `Link`, `Variable`, `TypedVariable`, `LinkTemplate` atoms combined
with `And` / `Or` / `Not`.  `matched(db, answer)` evaluates recursively
against any `DBInterface` backend and fills a `PatternMatchingAnswer` with a
set of frozen assignments (plus a negation flag).

This module is the *host* evaluator: the per-candidate loops mirror the
reference's (pattern_matcher.py:524-531, :732-738) and work against any
`DBInterface` backend.  Device execution does not hook into these classes —
routing happens above them, in `DistributedAtomSpace._dispatch_query`
(das_tpu_torch/api/atomspace.py), which hands compilable queries to
das_tpu_torch/query/compiler.py / tree.py and falls back to `matched()` here for
anything outside the compilable language.  Either path fills the same
`PatternMatchingAnswer` with identical assignment sets.
"""

from __future__ import annotations

from functools import cmp_to_key
from typing import List, Optional, Set

from das_tpu_torch.core.schema import WILDCARD
from das_tpu_torch.query.assignment import (
    Assignment,
    OrderedAssignment,
    UnorderedAssignment,
)


class PatternMatchingAnswer:
    def __init__(self):
        self.assignments: Set[Assignment] = set()
        self.negation: bool = False

    def __repr__(self):
        s = "NOT\n" if self.negation else ""
        for assignment in self.assignments:
            s += f"{assignment}\n"
        return s


class LogicalExpression:
    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        raise NotImplementedError

    def __repr__(self):
        return "<LogicalExpression>"


class Atom(LogicalExpression):
    def __init__(self, atom_type: str):
        self.atom_type = atom_type
        self.handle = None

    def __repr__(self):
        return f"{self.atom_type}"

    def get_handle(self, db) -> Optional[str]:
        raise NotImplementedError


class Node(Atom):
    def __init__(self, node_type: str, node_name: str):
        super().__init__(node_type)
        self.name = node_name

    def __repr__(self):
        return f"<{self.atom_type}: {self.name}>"

    def get_handle(self, db) -> Optional[str]:
        if not self.handle:
            self.handle = db.get_node_handle(self.atom_type, self.name)
        return self.handle

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        return db.node_exists(self.atom_type, self.name)


class Variable(Atom):
    def __init__(self, variable_name: str):
        super().__init__("ANY")
        self.name = variable_name

    def __repr__(self):
        return f"{self.name}"

    def get_handle(self, db) -> str:
        return WILDCARD

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        return True


class TypedVariable(Variable):
    def __init__(self, variable_name: str, variable_type: str):
        super().__init__(variable_name)
        self.type = variable_type

    def __repr__(self):
        return f"{self.name}: {self.type}"


class Link(Atom):
    """A link pattern whose targets are grounded atoms or (untyped)
    variables.  Unordered links keep grounded targets first, variables last
    (reference Link ctor comparator, pattern_matcher.py:442-453)."""

    def __init__(self, link_type: str, targets: List[Atom], ordered: bool):
        assert not any(isinstance(t, TypedVariable) for t in targets)
        super().__init__(link_type)
        self.ordered = ordered
        if ordered:
            self.targets = targets
        else:
            def comparator(t1, t2):
                if isinstance(t1, Variable):
                    return 1
                if isinstance(t2, Variable):
                    return -1
                return 0

            self.targets = sorted(targets, key=cmp_to_key(comparator))

    def __repr__(self):
        return f"<{self.atom_type}: {self.targets}>"

    def get_handle(self, db) -> Optional[str]:
        if not self.handle:
            target_handles = [t.get_handle(db) for t in self.targets]
            if any(h is None for h in target_handles):
                return None
            self.handle = db.get_link_handle(self.atom_type, target_handles)
        return self.handle

    def _assign_variables(self, db, link_targets: List[str]) -> Optional[Assignment]:
        assert len(link_targets) == len(self.targets)
        if self.ordered:
            answer = OrderedAssignment()
            for atom, handle in zip(self.targets, link_targets):
                if isinstance(atom, Variable):
                    if not answer.assign(atom.name, handle):
                        return None
            return answer if answer.freeze() else None
        answer = UnorderedAssignment()
        remaining = list(link_targets)
        variables = []
        for atom in self.targets:
            if isinstance(atom, Variable):
                variables.append(atom)
            else:
                grounded = atom.get_handle(db)
                if grounded in remaining:
                    remaining.remove(grounded)
        if len(variables) != len(remaining):
            return None
        for atom, handle in zip(variables, remaining):
            if not answer.assign(atom.name, handle):
                return None
        return answer if answer.freeze() else None

    def _typed_variable_matched(self, db, answer) -> bool:
        first = True
        for target in self.targets:
            if isinstance(target, Variable) and not isinstance(target, TypedVariable):
                return False
            if isinstance(target, TypedVariable):
                if not first:
                    return False
                first = False
        return all(t.matched(db, answer) for t in self.targets)

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        if any(isinstance(t, LinkTemplate) for t in self.targets):
            return self._typed_variable_matched(db, answer)
        if not all(t.matched(db, answer) for t in self.targets):
            return False
        target_handles = [t.get_handle(db) for t in self.targets]
        if any(h == WILDCARD for h in target_handles):
            matched = db.get_matched_links(self.atom_type, target_handles)
            answer.assignments = set()
            for link, targets in matched:
                asn = self._assign_variables(db, list(targets))
                if asn:
                    answer.assignments.add(asn)
            return bool(answer.assignments)
        return db.link_exists(self.atom_type, target_handles)


class LinkTemplate(LogicalExpression):
    """All-variable link pattern probing the type-template index."""

    def __init__(self, link_type: str, targets: List[TypedVariable], ordered: bool):
        assert all(isinstance(t, TypedVariable) for t in targets)
        self.link_type = link_type
        self.targets = targets
        self.ordered = ordered
        self.handle = None

    def __repr__(self):
        return f"<{self.link_type}: {self.targets}>"

    def _assign_variables(self, db, link_targets: List[str]) -> Optional[Assignment]:
        assert len(link_targets) == len(self.targets)
        answer = OrderedAssignment() if self.ordered else UnorderedAssignment()
        for variable, handle in zip(self.targets, link_targets):
            if not answer.assign(variable.name, handle):
                return None
        return answer if answer.freeze() else None

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        matched = db.get_matched_type_template(
            [self.link_type, *[v.type for v in self.targets]]
        )
        answer.assignments = set()
        for link, targets in matched:
            asn = self._assign_variables(db, list(targets))
            if asn:
                answer.assignments.add(asn)
        return bool(answer.assignments)


class Not(LogicalExpression):
    def __init__(self, term: LogicalExpression):
        self.term = term

    def __repr__(self):
        return f"NOT({self.term})"

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        self.term.matched(db, answer)
        answer.negation = not answer.negation
        return True


class Or(LogicalExpression):
    def __init__(self, terms: List[LogicalExpression]):
        self.terms = terms

    def __repr__(self):
        return f"OR({self.terms})"

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        if not self.terms:
            return False
        assert not answer.assignments
        union: Set[Assignment] = set()
        or_matched = False
        negative_terms = []
        for term in self.terms:
            if isinstance(term, Not):
                negative_terms.append(term)
                continue
            term_answer = PatternMatchingAnswer()
            if not term.matched(db, term_answer):
                continue
            or_matched = True
            if term_answer.assignments:
                union |= term_answer.assignments
        if negative_terms:
            # de-Morgan: OR of NOTs == NOT(AND); answers are the joint
            # negative matches not already covered positively
            joint = And([t.term for t in negative_terms])
            term_answer = PatternMatchingAnswer()
            joint.matched(db, term_answer)
            answer.assignments = term_answer.assignments - union
            answer.negation = True
        else:
            answer.assignments = union
        return or_matched


class And(LogicalExpression):
    def __init__(self, terms: List[LogicalExpression]):
        self.terms = terms

    def __repr__(self):
        return f"AND({self.terms})"

    def _join_assignment_sets(self, db, left: Set[Assignment], right: Set[Assignment]):
        """Pairwise join of two assignment sets.  Overridden by the device
        compiler for ordered-only workloads; this host fallback is the
        reference nested loop (pattern_matcher.py:732-738)."""
        joined = []
        for a in left:
            for b in right:
                j = a.join(b)
                if j is not None:
                    joined.append(j)
        return joined

    def matched(self, db, answer: PatternMatchingAnswer) -> bool:
        if not self.terms:
            return False
        assert not answer.assignments
        # NB: an empty accumulator is re-seeded by the next positive term —
        # observable behavior inherited from the reference accumulator test
        # (pattern_matcher.py:725-728), kept for answer-set parity.
        accumulated: Set[Assignment] = set()
        forbidden: Set[Assignment] = set()
        for term in self.terms:
            term_answer = PatternMatchingAnswer()
            if not term.matched(db, term_answer):
                return False
            if not term_answer.assignments:
                continue
            if term_answer.negation:
                forbidden |= term_answer.assignments
                continue
            if not accumulated:
                accumulated = term_answer.assignments
            else:
                accumulated = self._join_assignment_sets(
                    db, accumulated, term_answer.assignments
                )
        for assignment in accumulated:
            if all(assignment.check_negation(tabu) for tabu in forbidden):
                answer.assignments.add(assignment)
        return bool(answer.assignments)
