"""Composite binding tables (unordered/multiset semantics), as elementwise
PyTorch (port of `das_tpu/ops/composite.py`).

The reference joins `UnorderedAssignment` / `CompositeAssignment` objects
in Python (pattern_matcher.py:158-368): an unordered (Set/Similarity)
match is a multiset of symbols and values without a committed pairing,
and joins chain viability checks (`contains_ordered`,
`is_covered_by_ordered`, `compatible`) between the ordered map and every
multiset constraint.

Here a composite binding table is a padded int32 matrix whose columns
split into *ordered* variable columns plus one sorted-value block per
unordered constraint (the constraint's variable names are static; since
every frozen UnorderedAssignment binds k distinct variables exactly once,
its value multiset is k distinct values — the sorted block IS the
canonical identity).  The viability predicates become row-wise (or
row-pair-wise, for negation filtering) comparisons over those column
blocks, unrolled over the small column counts.  None of this is a
kernel in the JAX package either: it is lowered `jnp` there."""

from __future__ import annotations

import torch

_I32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# unordered term tables
# ---------------------------------------------------------------------------

def build_uterm_table(targets_sorted, local, mask, req_vals, n_required: int, k: int):
    """Project probed candidate links of an unordered pattern into a sorted
    value-block table (reference Link._assign_variables unordered branch).

    targets_sorted — [m_bucket, arity] canonically sorted target rows
    local/mask     — padded probe result (bucket-local rows + validity)
    req_vals       — int32[n_required] grounded target rows, with
                     multiplicity (one entry per required occurrence)
    k              — number of pattern variables (= arity - n_required)

    Per candidate: remove one occurrence of each required value from the
    sorted target multiset; the remaining k values (still sorted) are the
    value block.  A row survives only if every required value was found
    (multiset containment) and the k remaining values are pairwise
    distinct (UnorderedAssignment.freeze)."""
    safe = torch.clamp(local, 0, targets_sorted.shape[0] - 1).long()
    ts = targets_sorted[safe]                      # [cap, arity]
    arity = ts.shape[1]
    # run-rank r[p]: index of this occurrence within its equal-value run
    rank = torch.zeros(ts.shape, dtype=torch.int32, device=ts.device)
    for p in range(1, arity):
        eq_prev = torch.zeros(ts.shape[0], dtype=torch.int32, device=ts.device)
        for q in range(p):
            eq_prev = eq_prev + (ts[:, q] == ts[:, p]).to(torch.int32)
        rank[:, p] = eq_prev
    if n_required:
        req = torch.as_tensor(req_vals, dtype=torch.int32).to(ts.device)
        cnt_req = torch.zeros(ts.shape, dtype=torch.int32, device=ts.device)
        for i in range(n_required):
            cnt_req = cnt_req + (ts == req[i]).to(torch.int32)
        removed = rank < cnt_req
        mask = mask & (removed.sum(dim=1) == n_required)
    else:
        removed = torch.zeros(ts.shape, dtype=torch.bool, device=ts.device)
    remaining = torch.where(removed, _I32_MAX, ts)
    remaining = torch.sort(remaining, dim=1).values
    vals = remaining[:, :k]
    if k > 1:
        distinct = (vals[:, 1:] != vals[:, :-1]).all(dim=1)
        mask = mask & distinct
    vals = torch.where(mask[:, None], vals, 0).to(torch.int32)
    return vals, mask


# ---------------------------------------------------------------------------
# row-wise predicates over ONE table (post-join condition masks)
#
# Each takes the joined output values matrix plus static column-index tuples
# and returns a bool[rows] mask.  Ordered blocks are (names, cols) pairs;
# unordered blocks hold k distinct values each (see module docstring).
# ---------------------------------------------------------------------------

def _zeros(vals, dtype=torch.int32):
    return torch.zeros(vals.shape[0], dtype=dtype, device=vals.device)


def _ones(vals):
    return torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)


def contains_ordered_mask(vals, unames, ucols, onames, ocols):
    """UnorderedAssignment.contains_ordered: every ordered variable is one
    of the constraint's symbols and the ordered values' counts fit inside
    the constraint's value multiset."""
    if not set(onames) <= set(unames):
        return _zeros(vals, torch.bool)
    ok = _ones(vals)
    for i in ocols:
        cnt_u = _zeros(vals)
        for j in ucols:
            cnt_u = cnt_u + (vals[:, j] == vals[:, i]).to(torch.int32)
        cnt_om = _zeros(vals)
        for i2 in ocols:
            cnt_om = cnt_om + (vals[:, i2] == vals[:, i]).to(torch.int32)
        ok = ok & (cnt_u >= cnt_om)
    return ok


def covered_by_ordered_mask(vals, unames, ucols, onames, ocols):
    """UnorderedAssignment.is_covered_by_ordered: the ordered map fully
    accounts for the constraint — symbols all appear as ordered variables
    and every constraint value's multiplicity is matched by the ordered
    values."""
    if not set(unames) <= set(onames):
        return _zeros(vals, torch.bool)
    ok = _ones(vals)
    for j in ucols:
        mult_u = _zeros(vals)
        for j2 in ucols:
            mult_u = mult_u + (vals[:, j2] == vals[:, j]).to(torch.int32)
        mult_om = _zeros(vals)
        for i in ocols:
            mult_om = mult_om + (vals[:, i] == vals[:, j]).to(torch.int32)
        ok = ok & (mult_u <= mult_om)
    return ok


def viability_mask(vals, unames, ucols, onames, ocols):
    """CompositeAssignment._ordered_viable per-constraint disjunction:
    contains_ordered OR is_covered_by_ordered."""
    return contains_ordered_mask(vals, unames, ucols, onames, ocols) | (
        covered_by_ordered_mask(vals, unames, ucols, onames, ocols)
    )


def compatible_mask(vals, names1, cols1, names2, cols2):
    """UnorderedAssignment.compatible.  With distinct values per constraint
    both `have` sums equal the intersection size, and both `need` sums
    equal the shared-symbol count."""
    need = len(set(names1) & set(names2))
    if need == 0:
        return _ones(vals)
    inter = _zeros(vals)
    for j1 in cols1:
        for j2 in cols2:
            inter = inter + (vals[:, j1] == vals[:, j2]).to(torch.int32)
    return inter >= need


# ---------------------------------------------------------------------------
# pairwise negation predicates: answer table A x tabu table T -> bool[A, T]
#
# These mirror the reference's check_negation dispatch.  `excluded[a] =
# any_t pred(a, t)`; the caller keeps a row iff NOT excluded by any tabu
# row of any forbidden table.
# ---------------------------------------------------------------------------

def _eq(va, ca, vt, ct):
    return va[:, ca][:, None] == vt[:, ct][None, :]


def _false(va, vt):
    return torch.zeros((va.shape[0], vt.shape[0]), dtype=torch.bool, device=va.device)


def _true(va, vt):
    return torch.ones((va.shape[0], vt.shape[0]), dtype=torch.bool, device=va.device)


def pair_ordered_covers(va, a_names, a_cols, vt, t_names, t_cols):
    """OrderedAssignment.check_negation vs an ordered tabu: excluded iff
    the tabu mapping is a sub-map of the answer."""
    if not set(t_names) <= set(a_names):
        return None  # statically never excludes
    out = _true(va, vt)
    for n, tc in zip(t_names, t_cols):
        ac = a_cols[a_names.index(n)]
        out = out & _eq(va, ac, vt, tc)
    return out


def pair_u_covered_by_ordered(va, a_onames, a_ocols, vt, t_unames, t_ucols):
    """negation.is_covered_by_ordered(self) for an unordered tabu against
    an ordered answer."""
    if not set(t_unames) <= set(a_onames):
        return None
    out = _true(va, vt)
    for j in t_ucols:
        mult_t = _zeros(vt)
        for j2 in t_ucols:
            mult_t = mult_t + (vt[:, j2] == vt[:, j]).to(torch.int32)
        mult_a = torch.zeros((va.shape[0], vt.shape[0]), dtype=torch.int32, device=va.device)
        for i in a_ocols:
            mult_a = mult_a + _eq(va, i, vt, j).to(torch.int32)
        out = out & (mult_a >= mult_t[None, :])
    return out


def pair_u_contains_ordered(va, a_unames, a_ucols, vt, t_onames, t_ocols):
    """u.contains_ordered(tabu) with u on the answer side: tabu variables
    all symbols of u, tabu value counts fit in u's values."""
    if not set(t_onames) <= set(a_unames):
        return None
    out = _true(va, vt)
    for i in t_ocols:
        cnt_a = torch.zeros((va.shape[0], vt.shape[0]), dtype=torch.int32, device=va.device)
        for j in a_ucols:
            cnt_a = cnt_a + _eq(va, j, vt, i).to(torch.int32)
        cnt_t = _zeros(vt)
        for i2 in t_ocols:
            cnt_t = cnt_t + (vt[:, i2] == vt[:, i]).to(torch.int32)
        out = out & (cnt_a >= cnt_t[None, :])
    return out


def pair_u_contains_unordered(va, a_unames, a_ucols, vt, t_unames, t_ucols):
    """u.contains_unordered(tabu_u): symbol counts (static) and value
    counts both dominate the tabu's."""
    a_set = set(a_unames)
    if any(n not in a_set for n in t_unames):
        return None
    out = _true(va, vt)
    for j in t_ucols:
        present = _false(va, vt)
        for i in a_ucols:
            present = present | _eq(va, i, vt, j)
        out = out & present
    return out
