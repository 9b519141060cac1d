"""Variable-binding algebra.

Semantics-equivalent re-implementation of the reference assignment classes
(reference das/pattern_matcher/pattern_matcher.py:21-368):

* `OrderedAssignment` — a variable→value map.  Joining two assignments
  succeeds iff no shared variable binds different values; the join is the
  smaller-covering map or the union.
* `UnorderedAssignment` — the multiset binding produced by matching an
  unordered (Set/Similarity) link: a multiset of symbols and a multiset of
  values, *without* a committed pairing.  Freezing fails unless the count
  signatures agree.
* `CompositeAssignment` — one ordered map plus N unordered multiset
  constraints; maintained so that every unordered constraint stays
  satisfiable against the ordered map.

All are immutable after `freeze()` and hashable for set-level dedup.  The
`check_negation(tabu)` relation implements NOT-filtering: an answer survives
iff it is NOT covered by any forbidden assignment.

These objects live on the host: the TPU compiled path (das_tpu_torch/ops/join.py)
materializes ordered joins as int64 binding-table kernels and only converts
to these objects at the API boundary; unordered/composite queries run here.
"""

from __future__ import annotations

import copy
from enum import Enum, auto
from typing import Dict, List, Optional, Set

# Enforce different values for different variables in ordered assignments
# (reference CONFIG['no_overload']).
CONFIG = {"no_overload": False}


class Compatibility(int, Enum):
    INCOMPATIBLE = auto()
    NO_COVERING = auto()
    FIRST_COVERS_SECOND = auto()
    SECOND_COVERS_FIRST = auto()
    EQUAL = auto()


class Assignment:
    __slots__ = ("variables", "hash", "frozen")

    def __init__(self):
        self.variables: Set[str] = set()
        self.hash: int = 0
        self.frozen: bool = False

    def __hash__(self):
        assert self.hash
        return self.hash

    def __eq__(self, other):
        assert self.hash and other.hash
        return self.hash == other.hash

    def __lt__(self, other):
        assert self.hash and other.hash
        return self.hash < other.hash

    def _base_freeze(self) -> bool:
        if self.frozen:
            return False
        self.frozen = True
        self.variables = frozenset(self.variables)
        return True


class OrderedAssignment(Assignment):
    __slots__ = ("mapping", "values")

    def __init__(self):
        super().__init__()
        self.mapping: Dict[str, str] = {}
        self.values: Set[str] = set()

    def __repr__(self):
        return repr(self.mapping)

    def freeze(self) -> bool:
        assert self._base_freeze()
        self.values = frozenset(self.values)
        self.hash = hash(frozenset(self.mapping.items()))
        return True

    def assign(self, variable: str, value: str) -> bool:
        if variable is None or value is None or self.frozen:
            raise ValueError(
                f"Invalid assignment: variable = {variable} value = {value} "
                f"frozen = {self.frozen}"
            )
        if variable in self.variables:
            return self.mapping[variable] == value
        if CONFIG["no_overload"] and value in self.values:
            return False
        self.variables.add(variable)
        self.values.add(value)
        self.mapping[variable] = value
        return True

    def compatibility(self, other: "OrderedAssignment") -> Compatibility:
        assert other is not None
        if self.hash == other.hash:
            return Compatibility.EQUAL
        for variable in self.variables & other.variables:
            if self.mapping[variable] != other.mapping[variable]:
                return Compatibility.INCOMPATIBLE
        if other.variables < self.variables:
            return Compatibility.FIRST_COVERS_SECOND
        if self.variables < other.variables:
            return Compatibility.SECOND_COVERS_FIRST
        return Compatibility.NO_COVERING

    #: reference API name (pattern_matcher.py:141 `evaluate_compatibility`)
    evaluate_compatibility = compatibility

    def compatible(self, other: "OrderedAssignment") -> bool:
        return self.compatibility(other) != Compatibility.INCOMPATIBLE

    def join(self, other: Assignment) -> Optional[Assignment]:
        assert self.frozen and other.frozen
        if not isinstance(other, OrderedAssignment):
            return other.join(self)
        status = self.compatibility(other)
        if status == Compatibility.INCOMPATIBLE:
            return None
        if status in (Compatibility.EQUAL, Compatibility.FIRST_COVERS_SECOND):
            return self
        if status == Compatibility.SECOND_COVERS_FIRST:
            return other
        merged = OrderedAssignment()
        for variable, value in self.mapping.items():
            if not merged.assign(variable, value):
                return None
        for variable, value in other.mapping.items():
            if not merged.assign(variable, value):
                return None
        merged.freeze()
        return merged

    def check_negation(self, negation: Assignment) -> bool:
        if isinstance(negation, OrderedAssignment):
            status = self.compatibility(negation)
            return status not in (Compatibility.EQUAL, Compatibility.FIRST_COVERS_SECOND)
        return not negation.is_covered_by_ordered(self)


class UnorderedAssignment(Assignment):
    __slots__ = ("symbols", "values")

    def __init__(self):
        super().__init__()
        self.symbols: Dict[str, int] = {}  # symbol -> multiplicity
        self.values: Dict[str, int] = {}   # value  -> multiplicity

    def __repr__(self):
        symbols = [s for s, c in self.symbols.items() for _ in range(c)]
        values = [v for v, c in self.values.items() for _ in range(c)]
        return "*" + repr(dict(zip(symbols, values)))

    def freeze(self) -> bool:
        assert self._base_freeze()
        if tuple(sorted(self.symbols.values())) != tuple(sorted(self.values.values())):
            return False
        self.hash = hash(
            (hash(frozenset(self.symbols.items())), hash(frozenset(self.values.items())))
        )
        return True

    def assign(self, variable: str, value: str) -> bool:
        if variable is None or value is None or self.frozen:
            raise ValueError(
                f"Invalid assignment: variable = {variable} value = {value} "
                f"frozen = {self.frozen}"
            )
        if variable in self.variables:
            return False
        self.symbols[variable] = self.symbols.get(variable, 0) + 1
        self.values[value] = self.values.get(value, 0) + 1
        self.variables.add(variable)
        return True

    def join(self, other: Assignment) -> Optional[Assignment]:
        assert self.frozen and other.frozen
        if isinstance(other, CompositeAssignment):
            return other.join(self)
        return CompositeAssignment(self).join(other)

    def check_negation(self, negation: Assignment) -> bool:
        if isinstance(negation, OrderedAssignment):
            return not self.contains_ordered(negation)
        if isinstance(negation, UnorderedAssignment):
            return not self.contains_unordered(negation)
        return all(
            not self.contains_unordered(u) for u in negation.unordered_mappings
        )

    def contains_ordered(self, ordered: OrderedAssignment) -> bool:
        """True iff the ordered map could be one concretization of this
        multiset constraint: all its variables are ours and its value counts
        fit inside our value multiset."""
        needed: Dict[str, int] = {}
        for variable, value in ordered.mapping.items():
            if variable not in self.variables:
                return False
            needed[value] = needed.get(value, 0) + 1
        return all(self.values.get(v, 0) >= c for v, c in needed.items())

    def is_covered_by_ordered(self, ordered: OrderedAssignment) -> bool:
        symbols = dict(self.symbols)
        values = dict(self.values)
        for variable, value in ordered.mapping.items():
            symbols[variable] = symbols.get(variable, 0) - 1
            values[value] = values.get(value, 0) - 1
        return all(c <= 0 for c in symbols.values()) and all(
            c <= 0 for c in values.values()
        )

    def contains_unordered(self, other: "UnorderedAssignment") -> bool:
        for symbol, count in other.symbols.items():
            if self.symbols.get(symbol, 0) < count:
                return False
        for value, count in other.values.items():
            if self.values.get(value, 0) < count:
                return False
        return True

    def compatible(self, other: "UnorderedAssignment") -> bool:
        """Weak mutual-satisfiability test on shared symbols/values."""
        shared_symbols = self.variables & other.variables
        need_self = sum(self.symbols[s] for s in shared_symbols)
        need_other = sum(other.symbols[s] for s in shared_symbols)
        shared_values = set(self.values) & set(other.values)
        have_self = sum(self.values[v] for v in shared_values)
        have_other = sum(other.values[v] for v in shared_values)
        return have_other >= need_self and have_self >= need_other


class CompositeAssignment(Assignment):
    __slots__ = ("unordered_mappings", "ordered_mapping")

    def __init__(self, assignment: UnorderedAssignment):
        super().__init__()
        self.unordered_mappings: List[UnorderedAssignment] = [assignment]
        self.ordered_mapping: Optional[OrderedAssignment] = None
        self.variables = set(assignment.variables)
        assert self._base_freeze()
        self._recompute_hash()

    def __repr__(self):
        return f"Ordered = {self.ordered_mapping} | Unordered = {self.unordered_mappings}"

    def _recompute_hash(self):
        h = self.ordered_mapping.hash if self.ordered_mapping else 1
        for unordered in self.unordered_mappings:
            h ^= unordered.hash
        self.hash = h

    def _ordered_viable(self) -> bool:
        if not self.ordered_mapping:
            return bool(self.unordered_mappings)
        return all(
            u.contains_ordered(self.ordered_mapping)
            or u.is_covered_by_ordered(self.ordered_mapping)
            for u in self.unordered_mappings
        )

    def _add_ordered(self, other: Optional[OrderedAssignment]) -> bool:
        if other is None:
            pass
        elif self.ordered_mapping is None:
            self.ordered_mapping = other
        else:
            self.ordered_mapping = self.ordered_mapping.join(other)
            if self.ordered_mapping is None:
                return False
        if not self._ordered_viable():
            return False
        self._recompute_hash()
        return True

    def _add_unordered(self, unordered: UnorderedAssignment) -> bool:
        if self.ordered_mapping and not unordered.contains_ordered(self.ordered_mapping):
            return False
        if any(not u.compatible(unordered) for u in self.unordered_mappings):
            return False
        self.unordered_mappings.append(unordered)
        self._recompute_hash()
        return True

    def join(self, other: Assignment) -> Optional["CompositeAssignment"]:
        assert self.frozen and other.frozen
        answer = copy.deepcopy(self)
        if isinstance(other, OrderedAssignment):
            return answer if answer._add_ordered(other) else None
        if isinstance(other, UnorderedAssignment):
            return answer if answer._add_unordered(other) else None
        if not answer._add_ordered(other.ordered_mapping):
            return None
        if all(answer._add_unordered(u) for u in other.unordered_mappings):
            return answer
        return None

    def check_negation(self, negation: Assignment) -> bool:
        if isinstance(negation, OrderedAssignment):
            return all(
                not u.contains_ordered(negation) for u in self.unordered_mappings
            )
        if isinstance(negation, UnorderedAssignment):
            return all(
                not u.contains_unordered(negation) for u in self.unordered_mappings
            )
        for u in self.unordered_mappings:
            if all(u.contains_unordered(n) for n in negation.unordered_mappings):
                return False
        return True

    def contains_ordered(self, ordered: OrderedAssignment) -> bool:
        return all(u.contains_ordered(ordered) for u in self.unordered_mappings)

    def contains_unordered(self, unordered: UnorderedAssignment) -> bool:
        return all(u.contains_unordered(unordered) for u in self.unordered_mappings)

    def is_covered_by_ordered(self, ordered: OrderedAssignment) -> bool:
        """Whether `ordered` fully accounts for this composite: every
        unordered constraint is covered and our ordered part (if any) is a
        sub-map of `ordered`.  (The reference crashes on this path —
        pattern_matcher.py:117 calls a method UnorderedAssignment-only; this
        is the intended closure of that relation.)"""
        if self.ordered_mapping is not None:
            status = self.ordered_mapping.compatibility(ordered)
            if status not in (Compatibility.EQUAL, Compatibility.SECOND_COVERS_FIRST):
                return False
        return all(u.is_covered_by_ordered(ordered) for u in self.unordered_mappings)
