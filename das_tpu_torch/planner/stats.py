"""Cardinality estimation from the posting-index degree statistics (port
of `das_tpu/planner/stats.py`).

The store's host copies of its sorted indexes hold what a System-R style
estimator needs:

  * exact per-term candidate counts — the binary searches the device
    probes run (`query/fused.py estimate_plan_rows`);
  * exact distinct-value counts per (arity, type, position) — run-length
    boundaries in the contiguous (type_id << 32 | target) slice of the
    sorted `key_type_pos` index.

Joins estimate with the independence model

    |L join R|  ~  |L| * |R| * prod_{v shared} 1 / max(dv_L(v), dv_R(v))

except where both sides are base terms sharing one variable: then the
sparse degree dot product sum_v deg_L(v) * deg_R(v) is exact, and its
k-way form sum_v prod_j deg_j(v) sizes the multiway step.

The estimator is valid for one `delta_version` of the store (bumped by
every commit and rebuild, storage/delta.py); `estimator_for` rebuilds it
when the version moved.  Pure numpy over `storage/atom_table.py host_segments`."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from das_tpu_torch.query import starcount
from das_tpu_torch.query.fused import estimate_plan_rows
from das_tpu_torch.storage.atom_table import host_segments


def _probe_degrees(ia, ib, cb):
    """For every atom row in sorted `ia`, its multiplicity in the sorted
    support (ib, cb), 0 where absent: the smaller side binary-searches the
    larger."""
    if ia.size == 0 or ib.size == 0:
        return np.zeros(ia.shape, np.int64)
    pos = np.searchsorted(ib, ia)
    pos_safe = np.minimum(pos, ib.size - 1)
    match = ib[pos_safe] == ia
    return np.where(match, cb[pos_safe], 0).astype(np.int64)


class RelEstimate:
    """Estimated shape of one relation mid-plan: rows plus per-variable
    distinct counts.  `plan` is set while the relation is a base term."""

    __slots__ = ("rows", "dv", "plan")

    def __init__(self, rows: float, dv: Dict[str, float], plan=None):
        self.rows = rows
        self.dv = dv
        self.plan = plan


class CardinalityEstimator:
    """Per-store cardinality estimates, valid for one delta_version.
    Every statistic is memoized."""

    def __init__(self, db):
        self.db = db
        self.version = db.delta_version
        self._rows: Dict[Tuple, int] = {}
        self._distinct: Dict[Tuple[int, int, int], int] = {}

    @staticmethod
    def _plan_key(plan) -> Tuple:
        return (plan.arity, plan.type_id, plan.ctype, plan.fixed, plan.negated)

    def rows(self, plan) -> int:
        """EXACT candidate count of one term (host binary searches)."""
        key = self._plan_key(plan)
        hit = self._rows.get(key)
        if hit is None:
            hit = self._rows[key] = int(estimate_plan_rows(self.db, plan))
        return hit

    def distinct_at(self, arity: int, type_id: int, pos: int) -> int:
        """Distinct real targets at `pos` among links of `type_id`."""
        key = (arity, type_id, pos)
        hit = self._distinct.get(key)
        if hit is not None:
            return hit
        base = np.int64(type_id) << 32
        total = 0
        for b in host_segments(self.db, arity):
            keys = b.key_type_pos[pos]
            lo = int(np.searchsorted(keys, base, side="left"))
            hi = int(np.searchsorted(keys, base + (np.int64(1) << 31), side="left"))
            if hi > lo:
                total += 1 + int(np.count_nonzero(np.diff(keys[lo:hi])))
        self._distinct[key] = total
        return total

    def term_estimate(self, plan) -> RelEstimate:
        """Estimate for one materialized term table."""
        rows = self.rows(plan)
        dv: Dict[str, float] = {}
        for name, col in zip(plan.var_names, plan.var_cols):
            if plan.ctype is not None or plan.type_id is None:
                d = rows
            else:
                d = self.distinct_at(plan.arity, plan.type_id, col)
                if plan.fixed:
                    d = min(d, rows)
            dv[name] = float(max(min(d, rows), 1 if rows else 0))
        return RelEstimate(float(rows), dv, plan=plan)

    def _support(self, plan, var: str):
        """Sparse degree support of a base term over `var`, from the star
        count's host edition (query/starcount.py), whose caches are
        validated by host-segment identity so a commit invalidates them;
        None for shapes without one (templates, repeated variables)."""
        if plan.ctype is not None or plan.type_id is None or plan.eq_pairs:
            return None
        pos = plan.var_cols[plan.var_names.index(var)]
        spec = (plan.arity, plan.type_id, pos, tuple(plan.fixed))
        if plan.fixed:
            return starcount._host_sparse_deg(self.db, spec)
        return starcount._table_sparse(self.db, spec)

    def exact_join_rows(self, pa, pb, var: str) -> Optional[int]:
        """EXACT rows of a base-term join on ONE shared variable: the
        sparse degree dot product sum_v deg_a(v) * deg_b(v)."""
        pos_a = pa.var_cols[pa.var_names.index(var)]
        pos_b = pb.var_cols[pb.var_names.index(var)]
        key = ("dot", self._plan_key(pa), pos_a, self._plan_key(pb), pos_b)
        hit = self._rows.get(key)
        if hit is not None:
            return hit if hit >= 0 else None
        ea = self._support(pa, var)
        eb = self._support(pb, var)
        if ea is None or eb is None:
            self._rows[key] = -1
            return None
        (ia, ca), _ta = ea
        (ib, cb), _tb = eb
        if ia.size > ib.size:
            (ia, ca), (ib, cb) = (ib, cb), (ia, ca)
        out = int((ca * _probe_degrees(ia, ib, cb)).sum())
        self._rows[key] = out
        return out

    def multiway_rows(self, plans, var: str) -> Tuple[float, bool]:
        """(rows, exact) of the k-way star join of base terms on ONE
        shared variable: sum_v prod_j deg_j(v) over the intersection of
        the supports, exact when every clause has a support; else the
        pairwise model folded along the clauses."""
        key = ("mdot",) + tuple(
            (self._plan_key(p), p.var_cols[p.var_names.index(var)]) for p in plans
        )
        hit = self._rows.get(key)
        if hit is not None and hit >= 0:
            return float(hit), True
        if hit is None:
            sups = [self._support(p, var) for p in plans]
            if all(s is not None for s in sups):
                arrs = sorted(((ia, ca) for (ia, ca), _t in sups),
                              key=lambda t: t[0].size)
                base_i, prod = arrs[0][0], arrs[0][1].astype(np.int64)
                for ia, ca in arrs[1:]:
                    prod = prod * _probe_degrees(base_i, ia, ca)
                out = int(prod.sum()) if prod.size else 0
                self._rows[key] = out
                return float(out), True
            self._rows[key] = -1
        rels = [self.term_estimate(p) for p in plans]
        acc = rels[0]
        for r in rels[1:]:
            acc = self.join_estimate(acc, r)
        return acc.rows, False

    def pair_join_rows(self, left: RelEstimate, right: RelEstimate,
                       var: str) -> Tuple[float, bool]:
        """(rows, exact) of the join restricted to ONE shared variable: the
        capacity model of an index join, which materializes every
        candidate before the remaining shared columns verify."""
        if left.plan is not None and right.plan is not None:
            exact = self.exact_join_rows(left.plan, right.plan, var)
            if exact is not None:
                return float(exact), True
        return left.rows * right.rows / max(
            left.dv.get(var, 1.0), right.dv.get(var, 1.0), 1.0
        ), False

    def join_estimate(self, left: RelEstimate, right: RelEstimate) -> RelEstimate:
        """Fold one equi-join into the running estimate: exact for a
        base-term join on one shared variable, independence otherwise."""
        shared = [v for v in left.dv if v in right.dv]
        rows = None
        if len(shared) == 1 and left.plan is not None and right.plan is not None:
            exact = self.exact_join_rows(left.plan, right.plan, shared[0])
            if exact is not None:
                rows = float(exact)
        if rows is None:
            rows = left.rows * right.rows
            for v in shared:
                rows /= max(left.dv[v], right.dv[v], 1.0)
        dv: Dict[str, float] = {}
        for v, d in left.dv.items():
            dv[v] = min(d, right.dv[v]) if v in right.dv else d
        for v, d in right.dv.items():
            dv.setdefault(v, d)
        rows = max(rows, 0.0)
        for v in dv:
            dv[v] = max(min(dv[v], rows), 1.0 if rows else 0.0)
        return RelEstimate(rows, dv)


def estimator_for(db) -> CardinalityEstimator:
    """The store's live estimator, rebuilt when its delta_version moved:
    statistics invalidate exactly like result caches."""
    est = getattr(db, "_planner_estimator", None)
    if est is None or est.version != db.delta_version or est.db is not db:
        est = CardinalityEstimator(db)
        db._planner_estimator = est
    return est
