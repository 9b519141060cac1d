"""Closed-form counting for star-shaped conjunctions, the miner's joints
(port of `das_tpu/query/starcount.py`).

The pattern miner's composite queries (mining/miner.py `_composite`) are
STAR joins: every positive term shares exactly one variable (V0), and
every other variable is free and appears in exactly one term.  For that
shape the match count needs no pair expansion:

    count = sum_v  prod_t  deg_t(v)

where deg_t(v) is the number of links matching term t with the shared
variable bound to atom row v.  A composite assignment is one link choice
per term (free variables are bijective with a term's matching rows), so
the product of the independent per-v choices is exact: the number the
reference's nested-loop And join and the fused executor produce.

**The reseed quirk is computed, not dodged.**  The reference And re-seeds
an emptied accumulator from the next positive term: E_1 = t_1,
E_i = (t_i if E_{i-1} is empty else E_{i-1} join t_i), and the answer is
|E_n|.  On degree vectors that is the fold

    R <- deg_1 ;  R <- (deg_i  if sum R = 0  else  R * deg_i) ;  count = sum R

and an EMPTY positive term (sum deg_i = 0) makes the reference's And
fail outright, so any such term answers 0 whatever the fold says.  With
that guard the star route is total for its shape: every lane gets the
reference's count, zeros included, with no general-path fallback.

Routing: `plan_star` recognizes the shape (ordered terms only, no
negation, no eq_pairs, no templates); everything else goes to the general
executors.  Dangling (-1) element rows never join here, as on the fused
path.

**Two executions of the same algebra** (count-identical, held against
each other by the tests and on the card by chip_smoke.py):

* the host edition, which every entry point runs: sparse supports (unique shared-variable values and their
  multiplicities) from the host probe of the sorted indexes
  (storage/atom_table.py `host_probe_locals`); a whole-table term stays
  symbolic, its degree at a support point a range length of the sorted
  (type<<32|target) key; a table x table product extracts the smaller
  side's support by run-length over its contiguous key slice.  No dense
  [atom_count] vector, no device work, no fetch.  Cached per host-segment
  identity, so an incremental commit (a new overlay segment) invalidates.
* the device edition, `_device_count_group`: every lane through the
  dense degree-vector fold in torch on the store's device (`index_add_`
  for the degree vectors, int64 products and sums), one host fetch per
  GROUP of lanes (`FETCHES`).  No entry point selects it: it is the
  differential witness of the host fold, and the edition a faster device
  fold would start from.  The JAX package's counterpart is plain XLA, not
  a Pallas kernel, so it has no hand-written kernel.  Cached per
  (DeviceBucket identity, atom_count)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from das_tpu_torch.storage.atom_table import host_probe_locals, host_segments

#: host fetches of the device edition (one per GROUP of lanes)
FETCHES = {"n": 0}


# ---------------------------------------------------------------------------
# shape detection
# ---------------------------------------------------------------------------


class StarLane:
    """One star-shaped count query: per-term degree specs in REFERENCE
    order (the reseed verdict is order-sensitive)."""

    __slots__ = ("specs",)

    def __init__(self, specs):
        # spec: (arity, type_id, v0_pos, fixed); fixed == () = whole table
        self.specs = specs


def plan_star(db, plans) -> Optional[StarLane]:
    """The star lane of a list of compiler.TermPlan, or None when the shape
    does not apply (the caller takes the general executors)."""
    if plans is None or not isinstance(plans, list):
        return None
    if len(plans) < 2:
        return None
    var_seen: Dict[str, int] = {}
    for p in plans:
        if p.negated or p.ctype is not None or p.type_id is None:
            return None
        if p.eq_pairs:
            return None
        for name in p.var_names:
            var_seen[name] = var_seen.get(name, 0) + 1
    shared = [name for name, n in var_seen.items() if n == len(plans)]
    if len(shared) != 1:
        return None
    if any(n != 1 for name, n in var_seen.items() if name != shared[0]):
        return None
    s = shared[0]
    specs = []
    for p in plans:
        v0_pos = p.var_cols[p.var_names.index(s)]
        specs.append((p.arity, p.type_id, v0_pos, tuple(p.fixed)))
    return StarLane(tuple(specs))


def _evict_oldest(cache, pred, keep: int) -> None:
    """FIFO-evict the entries matching ``pred`` down to ``keep`` (dicts keep
    insertion order, so the front is the oldest): a miner cycling through
    more distinct terms than the bound keeps its newest working set."""
    matching = [k for k in cache if pred(k)]
    for k in matching[: max(0, len(matching) - keep)]:
        del cache[k]


# ---------------------------------------------------------------------------
# device edition: dense degree vectors on the store's device
# ---------------------------------------------------------------------------


def _deg_vector(type_ids, targets_col, type_id: int, atom_count: int) -> torch.Tensor:
    """Dense degree vector: deg[v] = |{links of type_id with column == v}|."""
    contrib = ((type_ids == type_id) & (targets_col >= 0)).to(torch.int32)
    safe = targets_col.clamp(0, atom_count - 1).long()
    return torch.zeros(atom_count, dtype=torch.int32, device=targets_col.device).index_add_(
        0, safe, contrib)


def _scatter_deg(vals, mask, atom_count: int) -> torch.Tensor:
    """Degree vector of a probed term's (padded) shared-variable column."""
    ok = (mask & (vals >= 0)).to(torch.int32)
    safe = vals.clamp(0, atom_count - 1).long()
    return torch.zeros(atom_count, dtype=torch.int32, device=vals.device).index_add_(0, safe, ok)


def _deg_cache(db) -> Dict:
    cache = getattr(db, "_star_deg_cache", None)
    if cache is None:
        cache = db._star_deg_cache = {}
    return cache


def _get_deg(db, arity: int, type_id: int, pos: int):
    """Cached whole-table degree vector.  Valid for (bucket identity,
    atom_count): a commit swaps the buckets it touches, but an untouched
    arity keeps its bucket object while the atom count grows, and a
    bucket-only check would then serve a vector of the old length."""
    cache = _deg_cache(db)
    bucket = db.dev.buckets.get(arity)
    if bucket is None or bucket.size == 0:
        return None
    atom_count = int(db.fin.atom_count)
    key = (arity, type_id, pos)
    hit = cache.get(key)
    if hit is not None and hit[0] is bucket and hit[1] == atom_count:
        return hit[2]
    deg = _deg_vector(bucket.type_id, bucket.targets[:, pos], int(type_id), atom_count)
    # dense vectors are [atom_count] int32 each: bound them by count apart
    # from the cheap probe entries (dense keys end in a position int, probe
    # keys in the fixed tuple)
    if sum(isinstance(k[2], int) for k in cache) >= 16:
        _evict_oldest(cache, lambda k: isinstance(k[2], int), 12)
    cache.pop(key, None)  # a refreshed entry moves to the FIFO's back
    cache[key] = (bucket, atom_count, deg)
    return deg


def _gather_col(targets, local, pos: int) -> torch.Tensor:
    safe = local.clamp(0, targets.shape[0] - 1).long()
    return targets[safe, pos]


def _term_deg(db, spec):
    """Degree vector of one term; None when its bucket is missing (the
    term is empty: count 0).  Probe results are cached without the shared
    variable's position: the same probe recurs with the shared variable at
    different positions, and only the gather differs."""
    arity, type_id, v0_pos, fixed = spec
    if not fixed:
        return _get_deg(db, arity, type_id, v0_pos)
    cache = _deg_cache(db)
    bucket = db.dev.buckets.get(arity)
    if bucket is None or bucket.size == 0:
        return None
    key = (arity, type_id, fixed)
    hit = cache.get(key)
    if hit is not None and hit[0] is bucket:
        local, mask = hit[2]
    else:
        local, mask = db.probe_ordered_padded(arity, type_id, fixed)
        # cache small probe columns only: an overflow-grown probe is padded
        # to its learned capacity, and many cached multi-MB rows would
        # compete with the store for device memory
        if local.shape[0] <= (1 << 20):
            if len(cache) > 256:
                _evict_oldest(cache, lambda k: not isinstance(k[2], int), 192)
            cache.pop(key, None)
            cache[key] = (bucket, None, (local, mask))
    vals = _gather_col(bucket.targets, local, v0_pos)
    return _scatter_deg(vals, mask, int(db.fin.atom_count))


def _star_fold(degs):
    """(per-term totals S[n], the reference fold's count) on the device:
    the reseeding accumulator on degree vectors (module docstring)."""
    term_totals = torch.stack([d.sum(dtype=torch.int64) for d in degs])
    acc = degs[0].to(torch.int64)
    for d in degs[1:]:
        d = d.to(torch.int64)
        # an emptied accumulator is RESEEDED by this term
        acc = torch.where(acc.sum() == 0, d, acc * d)
    return term_totals, acc.sum()


def _dispatch(db, lane: StarLane):
    """Queue one lane's fold without waiting: device (S, count), or an
    exact 0 (int) when a term's bucket is absent."""
    degs = []
    for spec in lane.specs:
        deg = _term_deg(db, spec)
        if deg is None:
            return 0
        degs.append(deg)
    return _star_fold(degs)


#: lanes dispatched between fetches: each probed term makes a transient
#: dense [atom_count] vector, so a bounded group bounds the transients
GROUP = 12


def _device_count_group(db, lanes: Sequence[StarLane]) -> List[int]:
    """The device fold over a lane list: one host fetch per GROUP."""
    results: List[int] = []
    for g in range(0, len(lanes), GROUP):
        outs = [_dispatch(db, lane) for lane in lanes[g: g + GROUP]]
        FETCHES["n"] += 1
        queued = [torch.cat([o[0], o[1].view(1)]) for o in outs if not isinstance(o, int)]
        host = torch.cat(queued).cpu().numpy() if queued else np.empty(0, np.int64)
        k = 0
        for o in outs:
            if isinstance(o, int):
                results.append(o)
                continue
            n = o[0].shape[0]
            term_totals, count = host[k: k + n], host[k + n]
            k += n + 1
            # an empty positive term: the reference's And fails outright
            results.append(0 if (term_totals == 0).any() else int(count))
    return results


# ---------------------------------------------------------------------------
# host edition: sparse supports, no device work
# ---------------------------------------------------------------------------


def _host_cache(db) -> Dict:
    cache = getattr(db, "_star_host_cache", None)
    if cache is None:
        cache = db._star_host_cache = {}
    return cache


def _cached(cache, key, segments):
    """The entry cached under ``key`` if it was built from exactly these
    host segments (identity), else None."""
    hit = cache.get(key)
    if (hit is not None and len(hit[0]) == len(segments)
            and all(a is b for a, b in zip(hit[0], segments))):
        return hit[1]
    return None


def _remember(cache, key, segments, ent):
    if len(cache) > 256:
        _evict_oldest(cache, lambda k: k[0] in ("sparse", "tsparse"), 192)
    cache.pop(key, None)  # a refreshed entry moves to the FIFO's back
    cache[key] = (tuple(segments), ent)
    return ent


def _host_sparse_deg(db, spec):
    """((sorted unique shared-variable values, int64 multiplicities),
    total) of a probed term, from the host probe; dangling (-1) targets
    are dropped (they never join).  None when the arity has no segment.
    Cached: the miner reuses its ~100 candidate terms across hundreds of
    composites."""
    arity, type_id, v0_pos, fixed = spec
    segments = host_segments(db, arity)
    if not segments:
        return None
    cache = _host_cache(db)
    key = ("sparse", arity, type_id, v0_pos, fixed)
    hit = _cached(cache, key, segments)
    if hit is not None:
        return hit
    chunks = []
    for b in segments:
        local = host_probe_locals(b, type_id, fixed)
        if local.size == 0:
            continue
        v0 = b.targets[local, v0_pos]
        v0 = v0[v0 >= 0]
        if v0.size:
            chunks.append(v0)
    if chunks:
        idx, cnt = np.unique(np.concatenate(chunks), return_counts=True)
        cnt = cnt.astype(np.int64)
        ent = ((idx.astype(np.int64), cnt), int(cnt.sum()))
    else:
        e = np.empty(0, dtype=np.int64)
        ent = ((e, e), 0)
    return _remember(cache, key, segments, ent)


def _mul(acc, d):
    """Pointwise product of two sparse degree representations (sorted
    unique idx, cnt): the intersection of the supports."""
    ai, ac = acc
    di, dc = d
    common, ia, ib = np.intersect1d(ai, di, assume_unique=True, return_indices=True)
    return common, ac[ia] * dc[ib]


def _table_total(db, arity: int, type_id: int, v0_pos: int) -> int:
    """Degree sum of a whole-table term: rows of the type whose shared
    position holds a real atom, as the [tid<<32, tid<<32 + 2^31) range of
    the sorted (type<<32|target) key.  A dangling (-1) target ORs to key
    -1 and falls outside, so this equals the dense edition's `col >= 0`
    sum (a raw type range would count the dangling rows, and corrupt the
    empty-term guard and any reseed that lands on the table term)."""
    base = np.int64(type_id) << 32
    total = 0
    for b in host_segments(db, arity):
        keys = b.key_type_pos[v0_pos]
        total += int(np.searchsorted(keys, base + (np.int64(1) << 31), side="left")) \
            - int(np.searchsorted(keys, base, side="left"))
    return total


def _table_deg_at(db, spec, idx: np.ndarray) -> np.ndarray:
    """deg_t(v) of a whole-table term at the given atom rows only: range
    lengths of the sorted (type<<32|target) key, segment by segment."""
    arity, type_id, v0_pos, _ = spec
    out = np.zeros(idx.shape[0], dtype=np.int64)
    base = np.int64(type_id) << 32
    for b in host_segments(db, arity):
        keys = b.key_type_pos[v0_pos]
        q = base | idx.astype(np.int64)
        out += np.searchsorted(keys, q, side="right") - np.searchsorted(keys, q, side="left")
    return out


def _table_sparse(db, spec):
    """((sorted unique values, int64 multiplicities), total) of a
    whole-table term at one position, by run-length over the contiguous
    (type<<32|target) slice of the sorted key (dangling targets fall
    outside the slice).  Overlay segments merge their run-length pairs.
    Cached like the probe supports."""
    arity, type_id, v0_pos, _ = spec
    segments = host_segments(db, arity)
    if not segments:
        return None
    cache = _host_cache(db)
    key = ("tsparse", arity, type_id, v0_pos)
    hit = _cached(cache, key, segments)
    if hit is not None:
        return hit
    base = np.int64(type_id) << 32
    parts = []  # (idx, cnt) per segment
    for b in segments:
        keys = b.key_type_pos[v0_pos]
        lo = int(np.searchsorted(keys, base, side="left"))
        hi = int(np.searchsorted(keys, base + (np.int64(1) << 31), side="left"))
        if hi <= lo:
            continue
        vals = keys[lo:hi] - base
        starts = np.r_[0, np.flatnonzero(np.diff(vals)) + 1]
        parts.append((vals[starts], np.diff(np.r_[starts, vals.size])))
    if not parts:
        ent = ((np.empty(0, np.int64), np.empty(0, np.int64)), 0)
    elif len(parts) == 1:
        idx, cnt = parts[0]
        ent = ((idx, cnt.astype(np.int64)), int(cnt.sum()))
    else:
        # the same value may appear in several segments
        allv = np.concatenate([p[0] for p in parts])
        allc = np.concatenate([p[1] for p in parts]).astype(np.int64)
        order = np.argsort(allv, kind="stable")
        sv, sc = allv[order], allc[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sv)) + 1]
        csum = np.r_[0, np.cumsum(sc)]
        bounds = np.r_[starts, sv.size]
        cnt = csum[bounds[1:]] - csum[bounds[:-1]]
        ent = ((sv[starts], cnt), int(cnt.sum()))
    return _remember(cache, key, segments, ent)


def _host_count(db, lane: StarLane) -> int:
    """One lane, exact, on the host: the module docstring's fold over
    (representation, total) entries.  A representation is ("table", spec)
    for a whole-table term held symbolic, or a sparse (idx, cnt) support.
    sparse x table reads the table's degrees at the support points;
    table x table extracts the smaller side's support and goes sparse."""
    reps = []  # (rep, total)
    for spec in lane.specs:
        arity, type_id, v0_pos, fixed = spec
        if not fixed:
            ent = (("table", spec), _table_total(db, arity, type_id, v0_pos))
        else:
            ent = _host_sparse_deg(db, spec)
        if ent is None or ent[1] == 0:
            return 0  # an empty positive term: the And fails outright
        reps.append(ent)

    def is_table(r):
        return isinstance(r, tuple) and isinstance(r[0], str)

    def mul(a, a_total, b, b_total):
        a_tab, b_tab = is_table(a), is_table(b)
        if a_tab and b_tab:
            # the smaller table goes sparse, the other stays symbolic
            if b_total < a_total:
                a, b = b, a
            ent = _table_sparse(db, a[1])
            a = ent[0] if ent is not None else (np.empty(0, np.int64), np.empty(0, np.int64))
            a_tab = False
        if a_tab or b_tab:
            rep, tab = (b, a) if a_tab else (a, b)
            idx, cnt = rep
            out = cnt * _table_deg_at(db, tab[1], idx)
            keep = out != 0
            return idx[keep], out[keep]
        return _mul(a, b)

    acc, acc_total = reps[0]
    for d, d_total in reps[1:]:
        if acc_total == 0:
            acc, acc_total = d, d_total  # the reference's reseed
        else:
            acc = mul(acc, acc_total, d, d_total)  # never symbolic after
            acc_total = int(acc[1].sum())
    return acc_total


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def star_count_many(db, lanes: Sequence[StarLane]) -> List[int]:
    """Every lane's exact count, by the host edition (no device work, no
    fetch)."""
    return [_host_count(db, lane) for lane in lanes]


def try_star_count(db, plans) -> Optional[int]:
    """The single-query surface for compiler.count_matches; None when the
    plans are not a star."""
    lane = plan_star(db, plans)
    if lane is None:
        return None
    return star_count_many(db, [lane])[0]
