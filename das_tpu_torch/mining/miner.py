"""Frequent-subgraph pattern miner (port of `das_tpu/mining/miner.py`; the
reference ships it as SimplePatternMiner.ipynb).

1. **Halo expansion**: every link within `halo_length` hops of the seed
   nodes, walked over the store's incoming sets.
2. **Pattern building**: for each halo link, every wildcard variant (each
   nonempty subset of targets made variables) becomes a candidate pattern
   with its match count (notebook cell 9 `build_patterns`).
3. **Mining**: sample `ngram`-term composites (roulette over halo levels
   by `depth_weight`), count their matches, and score them by
   **I-Surprisingness**: the distance of the observed probability from
   the band of independence estimates over the term partitions (notebook
   cell 5 `compute_isurprisingness`).

Counting on a TensorDB takes the host closed forms first: single-term
candidates by `trivial_plan_count`, star joints by the fold of
query/starcount.py (its host edition).  What they decline runs on the
card: `count_batch` for other conjunctions, then `count_matches_staged`
for what the batch declines,
and `count_matches` (fused, or the tree executor for unordered links) one
query at a time.  On a MemoryDB every count is the host algebra's.

Under one seed the miner draws the same samples in the same order as the
JAX package's (links are visited in sorted order, candidates are keyed by
`repr`), so both return the same patterns, counts and scores."""

from __future__ import annotations

import random
from dataclasses import dataclass
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES
from das_tpu_torch.query import compiler, starcount
from das_tpu_torch.query.ast import (
    And,
    Link,
    LogicalExpression,
    Node,
    PatternMatchingAnswer,
    Variable,
)
from das_tpu_torch.query.fused import get_executor, trivial_plan_count
from das_tpu_torch.storage.tensor_db import TensorDB


@dataclass
class MinedPattern:
    pattern: LogicalExpression
    count: int
    isurprisingness: float
    term_handles: Tuple[str, ...]


@dataclass
class _Candidate:
    pattern: Link
    count: int
    level: int


class PatternMiner:
    def __init__(
        self,
        db,
        halo_length: int = 2,
        depth_weight: Optional[Sequence[float]] = None,
        link_rate: float = 0.01,
        support: int = 1,
        seed: int = 0,
    ):
        self.db = db
        self.halo_length = halo_length
        self.depth_weight = list(depth_weight or [1.0] * halo_length)
        if len(self.depth_weight) != halo_length:
            raise ValueError("depth_weight needs one weight per halo level")
        self.link_rate = link_rate
        self.support = support
        self.rng = random.Random(seed)
        self.levels: List[Set[str]] = []
        self.candidates: List[List[_Candidate]] = []
        self.universe_size = 0
        self._joint_count_cache: Dict[frozenset, int] = {}

    # -- stage 1: halo ----------------------------------------------------

    def expand_halo(self, seed_handles: Sequence[str]) -> int:
        """Breadth-first walk over the incoming sets; returns the universe
        size (halo links).  Each level holds the links it newly discovered
        (notebook cell 6's difference pass)."""
        frontier = set(seed_handles)
        seen_links: Set[str] = set()
        self.levels = []
        for _level in range(self.halo_length):
            new_links: Set[str] = set()
            next_frontier: Set[str] = set()
            for node_handle in frontier:
                for link_handle in self.db.get_incoming(node_handle):
                    if link_handle in seen_links:
                        continue
                    new_links.add(link_handle)
                    for target in self.db.get_link_targets(link_handle):
                        next_frontier.add(target)
            seen_links.update(new_links)
            self.levels.append(new_links)
            frontier = next_frontier
        self.universe_size = len(seen_links)
        return self.universe_size

    # -- stage 2: patterns -------------------------------------------------

    def _wildcard_variants(self, link_handle: str) -> List[Link]:
        """Each nonempty subset of target positions made variables (the
        notebook's build_patterns variants).  A variant that grounds a
        target which is itself a link is skipped: `get_node_type` raises
        for it."""
        as_dict = self.db.get_atom_as_dict(link_handle)
        link_type = as_dict["type"]
        targets = as_dict["targets"]
        variants = []
        arity = len(targets)
        for mask in range(1, 2 ** arity):
            out = []
            var_index = 1
            skip = False
            for position, handle in enumerate(targets):
                if mask & (1 << position):
                    out.append(Variable(f"V{var_index}"))
                    var_index += 1
                else:
                    try:
                        out.append(Node(self.db.get_node_type(handle),
                                        self.db.get_node_name(handle)))
                    except ValueError:
                        skip = True  # the grounded target is a link
                        break
            if skip:
                continue
            variants.append(Link(link_type, out, link_type not in UNORDERED_LINK_TYPES))
        return variants

    def _fast_countable(self) -> bool:
        """The host closed forms (trivial single-term counts, the star
        fold) need only the finalized host store: both device backends
        have one (TensorDB and the sharded store)."""
        return getattr(self.db, "fin", None) is not None

    def count(self, query: LogicalExpression) -> int:
        """Exact match count, the device path first."""
        if isinstance(self.db, TensorDB):
            n = compiler.count_matches(self.db, query)
            if n is not None:
                return n
        elif self._fast_countable():
            # the sharded store: the host closed forms, then the router
            plans = compiler.plan_query(self.db, query)
            n = trivial_plan_count(self.db, plans)
            if n is not None:
                return n
            n = starcount.try_star_count(self.db, plans)
            if n is not None:
                compiler.ROUTE_COUNTS["star"] += 1
                return n
        return self._dispatch_count(query)

    def _dispatch_count(self, query: LogicalExpression) -> int:
        """The general path's count once the closed forms have declined:
        the shared router (the mesh, the single device, the host algebra),
        with the host algebra where the device path declines or
        overflows."""
        answer = PatternMatchingAnswer()
        matched = compiler.dispatch(self.db, query, answer)
        return len(answer.assignments) if matched else 0

    def count_many(self, queries: List[LogicalExpression]) -> List[int]:
        """Exact counts of many queries.  The host closed forms first:
        single-term candidates (`trivial_plan_count`) and star joints (the
        star fold).  The remaining conjunctions run through one
        `count_batch` on a TensorDB, and what it declines through the
        staged pipeline; on the sharded store through the router one by
        one.  Queries outside the conjunctive subset go to `count` one by
        one."""
        out: List[Optional[int]] = [None] * len(queries)
        if self._fast_countable() and queries:
            plans_list, idxs = [], []
            star_lanes, star_idxs = [], []
            for i, q in enumerate(queries):
                plans = compiler.plan_query(self.db, q)
                if plans is None:
                    continue
                n = trivial_plan_count(self.db, plans)
                if n is not None:
                    out[i] = n
                    continue
                lane = starcount.plan_star(self.db, plans)
                if lane is not None:
                    star_lanes.append(lane)
                    star_idxs.append(i)
                else:
                    plans_list.append(plans)
                    idxs.append(i)
            if star_lanes:
                # every star count is exact (the fold computes the reseed
                # semantics): no general-path recounts
                for i, n in zip(star_idxs, starcount.star_count_many(self.db, star_lanes)):
                    out[i] = n
                compiler.ROUTE_COUNTS["star"] += len(star_lanes)
            if plans_list and isinstance(self.db, TensorDB):
                ex = get_executor(self.db)
                for i, plans, n in zip(idxs, plans_list, ex.count_batch(plans_list)):
                    if n is None:
                        # the batch has shown that the fused path cannot
                        # honour the reference here: straight to staged
                        n = compiler.count_matches_staged(self.db, plans)
                    out[i] = n
            elif plans_list:
                # the sharded store: the closed forms above declined these
                for i in idxs:
                    out[i] = self._dispatch_count(queries[i])
        return [self.count(q) if n is None else n for q, n in zip(queries, out)]

    def build_patterns(self) -> int:
        """Build and count the candidate patterns of every halo level:
        level-0 links are all kept, deeper levels sampled at `link_rate`
        (notebook cell 9)."""
        self.candidates = []
        seen: Set[str] = set()
        per_level: List[List[Link]] = []
        for level, links in enumerate(self.levels):
            variants: List[Link] = []
            # sorted: deterministic sampling under a fixed seed
            for link_handle in sorted(links):
                if level > 0 and self.rng.random() > self.link_rate:
                    continue
                for variant in self._wildcard_variants(link_handle):
                    key = repr(variant)
                    if key in seen:
                        continue
                    seen.add(key)
                    variants.append(variant)
            per_level.append(variants)
        flat = [v for vs in per_level for v in vs]
        counts = iter(self.count_many(flat))
        for level, variants in enumerate(per_level):
            self.candidates.append(
                [_Candidate(v, n, level) for v in variants if (n := next(counts)) >= self.support]
            )
        return sum(len(c) for c in self.candidates)

    # -- stage 3: scoring --------------------------------------------------

    def _prob(self, count: int) -> float:
        return count / max(1, self.universe_size)

    def _composite(self, terms: List[Link]) -> LogicalExpression:
        """The conjunction of the terms with their variables renamed apart,
        except each term's first variable, which is shared (V0): the joint
        the miner scores."""
        renamed = []
        for i, term in enumerate(terms):
            targets = []
            for target in term.targets:
                if isinstance(target, Variable):
                    name = "V0" if target.name == "V1" else f"T{i}_{target.name}"
                    targets.append(Variable(name))
                else:
                    targets.append(target)
            renamed.append(Link(term.atom_type, targets, term.ordered))
        return And(renamed)

    def _subset_prob(self, terms: List[_Candidate], idxs: Tuple[int, ...]) -> float:
        """Probability of the conjunction of a subset of the terms; the
        joint counts of subsets of two or more are memoized for the whole
        run (the sampler draws the same combinations again and again)."""
        if len(idxs) == 1:
            return self._prob(terms[idxs[0]].count)
        key = frozenset(repr(terms[i].pattern) for i in idxs)
        n = self._joint_count_cache.get(key)
        if n is None:
            n = self.count(self._composite([terms[i].pattern for i in idxs]))
            self._joint_count_cache[key] = n
        return self._prob(n)

    def isurprisingness(self, count: int, terms: List[_Candidate],
                        normalized: bool = False) -> float:
        """I-Surprisingness of the joint against its independence estimates
        (notebook cell 5): over the full independence product and every
        binary partition {S, complement}, the signed distance of the
        observed p outside the [min, max] band of the estimates, so a
        pattern that co-occurs far less than predicted scores too."""
        p = self._prob(count)
        n = len(terms)
        estimates = [float(np.prod([self._prob(t.count) for t in terms]))]
        if n >= 3:
            # the side of each {S, complement} pair that holds index 0
            rest_all = range(1, n)
            for size in range(1, n):
                for tail in combinations(rest_all, size - 1):
                    subset = (0, *tail)
                    comp = tuple(i for i in rest_all if i not in tail)
                    if not comp:
                        continue
                    estimates.append(self._subset_prob(terms, subset)
                                     * self._subset_prob(terms, comp))
        surprise = max(p - max(estimates), min(estimates) - p)
        if normalized and p > 0:
            surprise /= p
        return surprise

    # -- mining loops ------------------------------------------------------

    def _roulette_level(self) -> int:
        weights = [w if self.candidates[i] else 0.0 for i, w in enumerate(self.depth_weight)]
        total = sum(weights)
        if total == 0:
            return 0
        x = self.rng.random() * total
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if x <= acc:
                return i
        return len(weights) - 1

    def mine(self, ngram: int = 3, epochs: int = 1000,
             normalized: bool = False) -> Optional[MinedPattern]:
        """Stochastic mining (notebook cell 11): sample ngram-term
        composites and keep the most surprising.  Every epoch's sample is
        drawn first and the composites are counted in one `count_many`;
        the subset joints that scoring needs are counted together in
        `_prefetch_joints`."""
        if not self.candidates or not self.candidates[0]:
            return None
        samples: List[List[_Candidate]] = []
        for _ in range(epochs):
            chosen = [self.rng.choice(self.candidates[0])]
            tries = 0
            while len(chosen) < ngram and tries < 50:
                tries += 1
                level = self._roulette_level()
                candidate = self.rng.choice(self.candidates[level])
                if any(c.pattern is candidate.pattern for c in chosen):
                    continue
                chosen.append(candidate)
            if len(chosen) == ngram:
                samples.append(chosen)
        composites = [self._composite([c.pattern for c in s]) for s in samples]
        counts = self.count_many(composites)
        kept = [(s, comp, n) for s, comp, n in zip(samples, composites, counts)
                if n >= self.support]
        self._prefetch_joints([s for s, _, _ in kept])
        best: Optional[MinedPattern] = None
        for chosen, composite, n in kept:
            score = self.isurprisingness(n, chosen, normalized)
            if best is None or score > best.isurprisingness:
                best = MinedPattern(composite, n, score, tuple(repr(c.pattern) for c in chosen))
        return best

    def _prefetch_joints(self, samples: List[List[_Candidate]]) -> None:
        """Count every subset joint that `isurprisingness` will ask for,
        in one `count_many`."""
        need: Dict[frozenset, List[Link]] = {}
        for chosen in samples:
            n = len(chosen)
            if n < 3:
                continue
            for size in range(2, n):
                for combo in combinations(range(n), size):
                    terms = [chosen[i].pattern for i in combo]
                    key = frozenset(repr(t) for t in terms)
                    if key not in self._joint_count_cache and key not in need:
                        need[key] = terms
        if not need:
            return
        keys = list(need)
        counts = self.count_many([self._composite(need[k]) for k in keys])
        self._joint_count_cache.update(zip(keys, counts))

    def mine_exhaustive(self, ngram: int = 2,
                        normalized: bool = False) -> Optional[MinedPattern]:
        """Deterministic sweep (notebook cell 12): every level-0 pattern
        against every (ngram-1)-combination of all patterns."""
        flat = [c for level in self.candidates for c in level]
        best: Optional[MinedPattern] = None
        for base in self.candidates[0]:
            for combo in combinations(flat, ngram - 1):
                if any(c.pattern is base.pattern for c in combo):
                    continue
                chosen = [base, *combo]
                composite = self._composite([c.pattern for c in chosen])
                n = self.count(composite)
                if n < self.support:
                    continue
                score = self.isurprisingness(n, chosen, normalized)
                if best is None or score > best.isurprisingness:
                    best = MinedPattern(composite, n, score,
                                        tuple(repr(c.pattern) for c in chosen))
        return best
