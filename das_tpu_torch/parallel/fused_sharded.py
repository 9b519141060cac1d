"""Fused execution of compiled conjunctions on the mesh (port of
`das_tpu/parallel/fused_sharded.py`).

The JAX package lowers a whole plan to ONE `shard_map` program.  Here the
plan runs as eager launches, shard by shard (`run_sharded_conj`), with the
same data movement between steps:

  * term probes are slab-local: every probed term of a plan in one probe
    launch per slab, no communication;
  * each join picks its collective statically from the sizes:
      - an index join (a whole link type on the right) gathers the small
        LEFT to every shard, and each shard probes its own slab's posting
        index: the right side never materializes;
      - a small right side is gathered whole to every shard
        (broadcast-right, one tiled all_gather);
      - a large one is HASH-PARTITIONED: both sides scatter their rows to
        shard `mix(join columns) % S` through one all_to_all each, equal
        keys co-locate, and each shard joins its own key range;
  * a multiway star prefix gathers every tail's term table and intersects
    against the local clause-0 slab;
  * negation gathers the negative table once;
  * the exact counts reduce over the shards (psum for totals, pmax for the
    per-shard capacity checks) into one stats vector

      [count, reseed, any_pos_empty, *term_ranges, *step_totals,
       *exchange_occupancies]

    that comes back in ONE host fetch per retry round.

Capacities are per shard, learned per plan signature and grown on
overflow, as in query/fused.py; an exchange slot count (the slots each
shard sends each destination) grows with its worst occupancy.  Every
kernel call is shard-local: one launch per slab per step.

On a mesh that spans processes (parallel/mesh.py) each process runs the
same plan over its own slabs, and the collectives cross the processes;
every decision reads replicated values only (the host records, S, the
reduced stats vector), so every rank makes the same calls.  Only
count-only jobs run there: materializing answers and whole-tree jobs
raise NotImplementedError."""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from das_tpu_torch import kernels, obs
from das_tpu_torch.obs import proflog
from das_tpu_torch.ops.join import SENTINEL_L, SENTINEL_R, dedup_table, mix_columns
from das_tpu_torch.ops.posting import search
from das_tpu_torch.parallel import mesh as M
from das_tpu_torch.query.fused import (
    ROUTE_CTYPE,
    ROUTE_TYPE,
    ROUTE_TYPE_POS,
    FusedTermSig,
    ResultCache,
    _pow2_at_least,
    _take_cols,
    _TreeExecJob,
    apply_index_joins,
    canonical_tree_names,
    clamp_index_terms,
    conj_stats_len,
    dispatch_pending,
    estimate_plan_rows,
    fetch,
    fold_join_meta,
    multiway_meta,
    order_plans,
    prepare_tree_job,
    program_model_bytes,
    run_tree_job,
    same_positive_order,
    settle_pending_iter,
    tree_model_bytes,
)

#: a right table whose whole capacity (S x per-shard cap) fits here is
#: gathered to every shard; a larger one hash-partitions
BROADCAST_LIMIT = 4096


@dataclass(frozen=True)
class ShardedPlanSig:
    terms: Tuple[FusedTermSig, ...]
    term_caps: Tuple[int, ...]   # per-shard probe capacities
    join_caps: Tuple[int, ...]   # per-shard step output capacities
    exch_caps: Tuple[int, ...]   # per step: slots per destination; 0 = no exchange
    n_shards: int
    #: per tail join: -1 moves tables (broadcast or exchange); else the
    #: posting-index position of an INDEX JOIN (the left is gathered)
    index_joins: Tuple[int, ...] = ()
    #: the cost-based planner ordered and seeded the plan
    planned: bool = False
    #: leading positives fused into one shard-local k-way step
    multiway: int = 0


@dataclass
class ShardedFusedResult:
    var_names: Tuple[str, ...]
    vals: Optional[List[torch.Tensor]]    # per shard [cap, k]; None if count-only
    valid: Optional[List[torch.Tensor]]
    count: int
    reseed_needed: bool
    host_vals: Optional[np.ndarray] = None   # [S, cap, k], fetched with the stats
    host_valid: Optional[np.ndarray] = None
    multiway: bool = False
    stats: Optional[np.ndarray] = None
    rounds: int = 0


def _scalar(x) -> torch.Tensor:
    return x.to(torch.int64).reshape(())


def _repartition(vals, valid, cols, sentinel: int, mesh: M.Mesh, q: int):
    """Scatter every shard's rows to shard `mix(cols) % S` through one
    all_to_all.  Returns (per-shard [S*q, k] received rows, their masks,
    per-shard worst destination occupancy).  A valid row takes slot = its
    rank among the shard's rows for that destination; invalid rows and
    slots >= q are dropped.  Validity travels as an extra column, and
    shard d receives sender s's slot `slot` at row s*q + slot."""
    S = mesh.size
    bufs, occs = [], []
    for s in range(mesh.n_local):
        v, m = vals[s], valid[s]
        k = v.shape[1]
        dev = v.device
        key = mix_columns(v, cols, m, sentinel)
        dest = torch.where(m, torch.remainder(key, S), S - 1).to(torch.int32)
        # one-hot destinations laid out [S, n], so that the rank is a scan
        # along the inner dimension (a scan over the outer one runs one
        # thread a column on the card)
        onehot = (dest[None, :] == torch.arange(S, dtype=torch.int32, device=dev)[:, None])
        onehot = onehot & m[None, :]
        rank = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32) - 1
        slot = torch.gather(rank, 0, dest[None, :].long())[0]
        occs.append(onehot.sum(dim=1, dtype=torch.int32).max())
        slot = torch.where(m, slot, q)
        packed = torch.cat([v, m.to(v.dtype)[:, None]], dim=1)
        # dropped rows write the spare row S*q, cut off below
        flat = torch.where(slot < q, dest.long() * q + slot.long(), S * q)
        buf = torch.zeros((S * q + 1, k + 1), dtype=v.dtype, device=dev)
        buf.index_copy_(0, flat, packed)
        bufs.append(buf[: S * q].view(S, q, k + 1))
    recv = M.all_to_all(bufs, mesh)
    k = vals[0].shape[1]
    return ([r[:, :k].contiguous() for r in recv], [r[:, k] != 0 for r in recv], occs)


def _gather_packed(vals, valid, mesh: M.Mesh):
    """A row-sharded table gathered whole to every shard with ONE
    collective (validity packed as an extra column)."""
    k = vals[0].shape[1]
    packed = [torch.cat([v, m.to(v.dtype)[:, None]], dim=1) for v, m in zip(vals, valid)]
    fulls = M.all_gather(packed, mesh)
    split: Dict[int, Tuple] = {}
    out_v, out_m = [], []
    for f in fulls:
        if id(f) not in split:   # one split per distinct copy (one per device)
            split[id(f)] = (f[:, :k].contiguous(), f[:, k] != 0)
        out_v.append(split[id(f)][0])
        out_m.append(split[id(f)][1])
    return out_v, out_m


def _global_count(valid, mesh: M.Mesh) -> torch.Tensor:
    """Surviving rows of a row-sharded mask over all shards (ONE psum)."""
    return _scalar(M.psum([m.sum() for m in valid], mesh))


def _per_shard(mesh: M.Mesh, fn):
    """fn(s) for every local slab s, each under its slab's device."""
    out = []
    for s in range(mesh.n_local):
        with mesh.on_shard(s):
            out.append(fn(s))
    return out


def run_sharded_conj(sig: ShardedPlanSig, mesh: M.Mesh, bucket_arrays, keys, fixed_vals):
    """Run ONE conjunction on the mesh: the slab-local probes, each step's
    collective and shard-local kernel, the anti-joins and the stats
    reductions.  bucket_arrays[i] is the term's (sorted keys, perm,
    targets, type_id), each a per-shard list.  Returns (per-shard
    acc_vals, per-shard acc_valid, stats) with stats the replicated int64
    vector [count, reseed, any_pos_empty, *term_ranges, *step_totals,
    *exchange_occupancies]; nothing here waits for the device."""
    positives, _negatives, _names, join_meta, anti_meta = fold_join_meta(sig.terms)
    mw = sig.multiway
    start = mw if mw else 1
    index_joins = sig.index_joins or tuple([-1] * max(0, len(positives) - start))
    index_right = {positives[start + t]: t for t, p in enumerate(index_joins) if p >= 0}
    zero = torch.zeros((), dtype=torch.int64, device=M.replicated(mesh))

    probed = [i for i in range(len(sig.terms)) if i not in index_right]

    def probe(s):
        return kernels.probe_term_tables([
            kernels.ProbeTerm(bucket_arrays[i][0][s], bucket_arrays[i][1][s],
                              bucket_arrays[i][2][s], keys[i], fixed_vals[i], sig.term_caps[i],
                              sig.terms[i].var_cols, sig.terms[i].eq_pairs,
                              sig.terms[i].extra_fixed)
            for i in probed])

    probes = _per_shard(mesh, probe)
    tables = {}
    term_ranges = []
    pos_count = {}
    for i in range(len(sig.terms)):
        if i in index_right:
            # never materialized: the type's range in every slab's
            # (type<<32|target) index, summed over the shards
            tid = int(keys[i])
            ks = bucket_arrays[i][0]
            pos_count[i] = M.psum([search(ks[s], (tid + 1) << 32, "left")
                                   - search(ks[s], tid << 32, "left")
                                   for s in range(mesh.n_local)], mesh)
            tables[i] = None
            term_ranges.append(zero)
            continue
        j = probed.index(i)
        vals = [p[j][0] for p in probes]
        mask = [p[j][1] for p in probes]
        tables[i] = (vals, mask)
        pos_count[i] = M.psum([m.sum() for m in mask], mesh)
        term_ranges.append(_scalar(M.pmax([p[j][2] for p in probes], mesh)))

    any_pos_empty = torch.zeros((), dtype=torch.bool, device=zero.device)
    for i in positives:
        any_pos_empty = any_pos_empty | (pos_count[i] == 0)

    acc_vals, acc_valid = tables[positives[0]]
    if len(positives) > 1:
        reseed = pos_count[positives[0]] == 0
    else:
        reseed = torch.zeros((), dtype=torch.bool, device=zero.device)
    join_totals = []
    exch_stats = []
    if mw:
        # shard-local k-way step: every tail's table gathered once, each
        # shard intersecting against its LOCAL clause-0 slab; every output
        # row has one clause-0 source row on one shard, so the union over
        # the shards is the full join.  Partial totals are per shard: the
        # reseed rule reads their sums, the capacity check their maxima.
        mw_meta, mw_vcol0 = multiway_meta(join_meta, mw)
        tails = [_gather_packed(*tables[i], mesh) for i in positives[1:mw]]
        outs = _per_shard(mesh, lambda s: kernels.multiway_join(
            acc_vals[s], acc_valid[s], [(tv[s], tm[s]) for tv, tm in tails],
            mw_vcol0, mw_meta, sig.join_caps[0]))
        acc_vals = [o[0] for o in outs]
        acc_valid = [o[1] for o in outs]
        g_totals = M.psum([o[2] for o in outs], mesh)
        join_totals.append(_scalar(M.pmax([o[2][mw - 2] for o in outs], mesh)))
        exch_stats.append(zero)
        for t in range(max(0, min(mw - 1, len(positives) - 2))):
            reseed = reseed | (g_totals[t] == 0)
    for t_step, i in enumerate(positives[start:]):
        n = start - 1 + t_step     # absolute join position
        pairs, extra = join_meta[n]
        jc = sig.join_caps[(1 if mw else 0) + t_step]
        q = sig.exch_caps[(1 if mw else 0) + t_step]
        if index_joins[t_step] >= 0:
            # the small left gathered once; each shard probes its own slab's
            # posting index (each link lives in exactly one slab)
            lv_full, lm_full = _gather_packed(acc_vals, acc_valid, mesh)
            ks, perm, targets, _tid = bucket_arrays[i]
            outs = _per_shard(mesh, lambda s: kernels.index_join(
                lv_full[s], lm_full[s], ks[s], perm[s], targets[s], keys[i], pairs,
                sig.terms[i].var_cols, extra, jc))
            exch_stats.append(zero)
        else:
            rv, rm = tables[i]
            if q == 0:
                # broadcast-right: the small side gathered whole
                rv_full, rm_full = _gather_packed(rv, rm, mesh)
                outs = _per_shard(mesh, lambda s: kernels.join_tables(
                    acc_vals[s], acc_valid[s], rv_full[s], rm_full[s], pairs, extra, jc))
                exch_stats.append(zero)
            else:
                # hash-partitioned: equal keys co-locate, each shard joins
                # its own key range
                lcols = tuple(lc for lc, _ in pairs)
                rcols = tuple(rc for _, rc in pairs)
                lv2, lm2, l_occ = _repartition(acc_vals, acc_valid, lcols, SENTINEL_L, mesh, q)
                rv2, rm2, r_occ = _repartition(rv, rm, rcols, SENTINEL_R, mesh, q)
                outs = _per_shard(mesh, lambda s: kernels.join_tables(
                    lv2[s], lm2[s], rv2[s], rm2[s], pairs, extra, jc))
                exch_stats.append(_scalar(M.pmax(
                    [torch.maximum(a, b) for a, b in zip(l_occ, r_occ)], mesh)))
        acc_vals = [o[0] for o in outs]
        acc_valid = [o[1] for o in outs]
        join_totals.append(_scalar(M.pmax([o[2] for o in outs], mesh)))
        if n < len(positives) - 2:
            reseed = reseed | (_global_count(acc_valid, mesh) == 0)

    for i, pairs in anti_meta:
        rv_full, rm_full = _gather_packed(*tables[i], mesh)
        acc_valid = _per_shard(mesh, lambda s: kernels.anti_join(
            acc_vals[s], acc_valid[s], rv_full[s], rm_full[s], pairs))

    count = _global_count(acc_valid, mesh)
    reseed = reseed & ~any_pos_empty
    stats = torch.stack([count, _scalar(reseed), _scalar(any_pos_empty),
                         *term_ranges, *join_totals, *exch_stats])
    return acc_vals, acc_valid, stats


@dataclass(frozen=True)
class ShardedTreeSig:
    """One whole-tree mesh job: every positive Or branch as a full sharded
    plan signature, plus the joint negative conjunction."""

    sites: Tuple[ShardedPlanSig, ...]
    neg: Optional[ShardedPlanSig] = None


def build_sharded_tree_fused(sig: ShardedTreeSig, mesh: M.Mesh):
    """The whole Or/negation tree on the mesh as one function: every site
    runs `run_sharded_conj`, the positive branches are projected onto the
    canonical columns and concatenated per shard, then either deduplicated
    SHARD-LOCALLY (duplicates across shards die in the host assignment set)
    or, with a negative branch, the whole union is gathered to every shard
    and the negative table anti-joined against it on all columns (a
    negative row must go on whichever shard it lives).  The replicated
    final count therefore bounds the distinct answers from above.

    Returns (fn, names); fn(*site_inputs) returns (per-shard vals,
    per-shard valid, stats) with stats [final_count, *site blocks], each
    block run_sharded_conj's stats vector."""
    out_names = canonical_tree_names(sig.sites[0].terms)
    K = len(out_names)
    perms = []
    for ssig in sig.sites + ((sig.neg,) if sig.neg is not None else ()):
        names = fold_join_meta(ssig.terms)[2]
        assert tuple(sorted(names)) == out_names, (
            "tree fusion requires one shared variable universe"
        )
        perms.append(tuple(names.index(v) for v in out_names))
    L = mesh.n_local

    def fn(*site_inputs):
        blocks = []
        parts = []
        for i, ssig in enumerate(sig.sites):
            ba, ks, fv = site_inputs[i]
            v, m, sl = run_sharded_conj(ssig, mesh, ba, ks, fv)
            blocks.append(sl)
            parts.append(([_take_cols(x, perms[i]) for x in v], m))
        union_vals = [torch.cat([p[0][s] for p in parts], dim=0) for s in range(L)]
        union_valid = [torch.cat([p[1][s] for p in parts], dim=0) for s in range(L)]
        if sig.neg is not None:
            ba, ks, fv = site_inputs[len(sig.sites)]
            nv, nm, nsl = run_sharded_conj(sig.neg, mesh, ba, ks, fv)
            blocks.append(nsl)
            nv = [_take_cols(x, perms[-1]) for x in nv]
            uv_full, um_full = _gather_packed(union_vals, union_valid, mesh)
            all_pairs = tuple((c, c) for c in range(K))
            out_valid = _per_shard(mesh, lambda s: kernels.anti_join(
                nv[s], nm[s], uv_full[s], um_full[s], all_pairs))
            out_vals = nv
        else:
            deduped = _per_shard(mesh, lambda s: dedup_table(union_vals[s], union_valid[s]))
            out_vals = [d[0] for d in deduped]
            out_valid = [d[1] for d in deduped]
        count = _global_count(out_valid, mesh)
        stats = torch.cat([count.reshape(1), *blocks])
        return out_vals, out_valid, stats

    return fn, out_names


class ShardedFusedExecutor:
    """Per-store executor on the mesh: plan arguments, per-shard capacity
    seeds and the learned capacities per plan signature, the static
    collective choice of every step, and the answered-result caches."""

    def __init__(self, db):
        self.db = db
        self.mesh = db.mesh
        self.n_shards = db.mesh.size
        self.broadcast_limit = BROADCAST_LIMIT
        self._caps: Dict[Tuple, Tuple] = {}
        #: answered results, valid for one delta_version (the serving path
        #: opts in; a re-partition replaces db.tables and this executor)
        self.results = ResultCache(db)
        #: the tree executor's cache (query/tree.py), same version guard
        self.tree_results = ResultCache(db)
        #: ShardedTreeSig -> (fn, names), bounded in _TreeExecJob.dispatch
        self._tree_progs: Dict[ShardedTreeSig, Tuple] = {}

    # -- plan mapping ----------------------------------------------------------

    def _term_args(self, plan):
        sb = self.db.tables.buckets.get(plan.arity)
        if sb is None:
            return None
        if plan.ctype is not None:
            route, p0, extra = ROUTE_CTYPE, -1, ()
            arrays = (sb.key_ctype, sb.order_by_ctype, sb.targets, sb.type_id)
            key = np.int64(plan.ctype)
        elif plan.type_id is not None and plan.fixed:
            p0, v0 = plan.fixed[0]
            route, extra = ROUTE_TYPE_POS, tuple(p for p, _ in plan.fixed[1:])
            arrays = (sb.key_type_pos[p0], sb.order_by_type_pos[p0], sb.targets, sb.type_id)
            key = (np.int64(plan.type_id) << 32) | np.int64(v0)
        else:
            route, p0, extra = ROUTE_TYPE, -1, ()
            # the slabs' type index holds int64 keys
            arrays = (sb.key_type, sb.order_by_type, sb.targets, sb.type_id)
            key = np.int64(plan.type_id)
        fixed_vals = np.asarray(
            [v for _, v in plan.fixed[1:]] if route == ROUTE_TYPE_POS else [], dtype=np.int32)
        sig = FusedTermSig(arity=plan.arity, route=route, p0=p0, extra_fixed=extra,
                           var_cols=plan.var_cols, eq_pairs=plan.eq_pairs,
                           var_names=plan.var_names, negated=plan.negated)
        return sig, arrays, key, fixed_vals

    def _estimate(self, plan) -> int:
        return estimate_plan_rows(self.db, plan)

    def _shard_cap(self, global_est: int) -> int:
        """Per-shard probe capacity: the even split with 2x skew headroom
        (slabs are round-robin; the overflow retry covers hub skew)."""
        per = -(-max(global_est, 1) // self.n_shards)
        return _pow2_at_least(2 * per)

    # -- execution -------------------------------------------------------------

    def _exec_job(self, plans, count_only: bool) -> Optional["_ShardedExecJob"]:
        """Order the plan (the planner behind config.use_planner, else the
        greedy order), map its terms, seed the per-shard capacities and
        choose every step's collective.  None when a bucket is missing or
        a capacity passes max_result_capacity (the staged mesh pipeline
        then answers)."""
        from das_tpu_torch import planner as _planner

        if not count_only:
            self.mesh.require_one_process("materializing answers")
        planned = (_planner.plan_conjunction(self.db, plans, n_shards=self.n_shards)
                   if _planner.enabled(self.db.config) else None)
        mw = planned.multiway if planned is not None else 0
        if planned is not None:
            ordered = [plans[i] for i in planned.order]
        else:
            ordered = order_plans(plans, self._estimate)
        same_order = same_positive_order(ordered, plans)
        plans = ordered
        mapped = []
        for plan in plans:
            m = self._term_args(plan)
            if m is None:
                return None
            mapped.append(m)
        sigs = tuple(m[0] for m in mapped)
        arrays = tuple(m[1] for m in mapped)
        keys = tuple(m[2] for m in mapped)
        fvals = tuple(m[3] for m in mapped)

        cfg = self.db.config
        ests = [self._estimate(p) for p in plans]
        term_caps = tuple(self._shard_cap(e) for e in ests)
        index_joins, index_right, arrays, term_caps = apply_index_joins(
            self.db.tables.buckets, sigs, arrays, term_caps, start_join=max(0, mw - 1))
        positives = [p for p in plans if not p.negated]
        n_joins = (len(positives) - mw + 1) if mw else max(0, len(positives) - 1)
        grounded = [e for p, e in zip(plans, ests)
                    if p.fixed and p.ctype is None and not p.negated]
        if grounded:
            mg = max(grounded)
            jcap0 = _pow2_at_least(max(64, min(cfg.initial_result_capacity, 4 * mg), mg))
        else:
            jcap0 = _pow2_at_least(max(cfg.initial_result_capacity // self.n_shards, *term_caps))
        if planned is not None and len(planned.join_cap_seeds) == n_joins:
            join_caps = planned.join_cap_seeds  # per-shard costed seeds
        else:
            join_caps = tuple([jcap0] * n_joins)
        # the static collective of every step: the multiway step gathers
        # its tails (slot 0); an index join gathers the left; else the
        # right is gathered when its whole capacity fits the broadcast
        # limit, and hash-partitioned otherwise
        pos_sig_idx = [i for i, s in enumerate(sigs) if not s.negated]
        exch_caps = [0] if mw else []
        ij_of = ([-1] if mw else []) + list(index_joins)
        for t in range(len(index_joins)):
            if index_joins[t] >= 0:
                exch_caps.append(0)
                continue
            right_cap = term_caps[pos_sig_idx[(mw if mw else 1) + t]]
            if right_cap * self.n_shards <= self.broadcast_limit:
                exch_caps.append(0)
            else:
                exch_caps.append(_pow2_at_least(2 * max(jcap0 // self.n_shards, 16)))
        exch_caps = tuple(exch_caps)
        learned = self._caps.get(sigs)
        # caps learned on the chain must not zip-truncate into the multiway
        # route's per-step layout, or the other way round
        if learned is not None and (len(learned[0]) != len(term_caps)
                                    or len(learned[1]) != len(join_caps)
                                    or len(learned[2]) != len(exch_caps)):
            learned = None
        if learned is not None:
            term_caps = clamp_index_terms(
                tuple(max(a, b) for a, b in zip(term_caps, learned[0])), index_right)
            join_caps = tuple(max(a, b) for a, b in zip(join_caps, learned[1]))
            exch_caps = tuple(
                (0 if b == 0 or n_ij >= 0 else max(a, b))
                for (a, b), n_ij in zip(zip(exch_caps, learned[2]), ij_of))
        if max(term_caps + join_caps, default=0) > cfg.max_result_capacity:
            return None
        # counted once the job exists: a decline runs the staged pipeline
        if planned is not None:
            _planner.record_planned(planned)
        else:
            _planner.PLANNER_COUNTS["greedy"] += 1
        return _ShardedExecJob(self, count_only, same_order, sigs, arrays, keys, fvals,
                               term_caps, join_caps, exch_caps, index_joins,
                               planned=planned, multiway=mw)

    def execute(self, plans, count_only: bool = False,
                use_cache: bool = False) -> Optional[ShardedFusedResult]:
        """Run the plan with one host fetch per retry round.  None when a
        bucket is missing or a capacity passes the ceiling.  use_cache as in
        query/fused.py: the serving path opts in."""
        if use_cache:
            cache_key = self.results.key(plans, count_only)
            hit = self.results.get(cache_key)
            if hit is not None:
                return hit
            cache_version = self.results.version()
        job = self._exec_job(plans, count_only)
        if job is None:
            return None
        while True:
            out = job.dispatch()
            if job.settle(fetch(*out), out):
                if use_cache:
                    self.results.put(cache_key, job.result, cache_version)
                return job.result

    def dispatch_many(self, plans_lists, count_only: bool = False, cache_only: bool = False):
        """The serving pipeline's first half on the mesh (query/fused.py
        dispatch_pending): cache hits, in-batch dedup, and every other
        job's first round enqueued with no host fetch."""
        return dispatch_pending(self.results, self._exec_job, plans_lists, count_only,
                                cache_only=cache_only)

    def settle_many_iter(self, pending):
        """The serving pipeline's second half (query/fused.py
        settle_pending_iter): one host fetch a retry round for the batch."""
        return settle_pending_iter(self.results, pending)

    def tree_exec_job(self, pos_sites, neg_plans=None):
        """One whole-tree mesh job (query/fused.py prepare_tree_job with the
        sharded job class)."""
        self.mesh.require_one_process("the whole-tree job")
        return prepare_tree_job(self, pos_sites, neg_plans, _ShardedTreeExecJob)

    def execute_tree(self, pos_sites, neg_plans=None):
        job = self.tree_exec_job(pos_sites, neg_plans)
        if job is None:
            return None
        return run_tree_job(job)


class _ShardedExecJob:
    """One mesh execution's state, split into dispatch and settle halves
    (the query/fused.py _ExecJob idiom): the same capacity retry (term,
    step and exchange slots), reseed verdict and capacity learning."""

    def __init__(self, ex, count_only, same_order, sigs, arrays, keys, fvals, term_caps,
                 join_caps, exch_caps, index_joins, planned=None, multiway=0):
        self.ex = ex
        self.count_only = count_only
        self.same_order = same_order
        self.sigs = sigs
        self.arrays = arrays
        self.keys = keys
        self.fvals = fvals
        self.term_caps = term_caps
        self.join_caps = join_caps
        self.exch_caps = exch_caps
        self.index_joins = index_joins
        self.planned = planned
        self.multiway = multiway
        self.names = fold_join_meta(sigs)[2]
        self.result: Optional[ShardedFusedResult] = None
        self.rounds = 0
        self.last_ranges = None
        self.last_join_rows = None
        #: False for the site jobs of a whole-tree job (it counts its answer)
        self.count_route = True

    def plan_sig(self) -> ShardedPlanSig:
        return ShardedPlanSig(self.sigs, self.term_caps, self.join_caps, self.exch_caps,
                              self.ex.n_shards, self.index_joins, self.planned is not None,
                              self.multiway)

    def dispatch(self) -> Tuple[torch.Tensor, ...]:
        """Enqueue one round at the current capacities, waiting for
        nothing.  Returns (stats,) for a count, else (stats, *vals,
        *valid) with one vals and one valid tensor per shard."""
        from das_tpu_torch.planner import PLANNER_COUNTS

        self.rounds += 1
        if self.planned is not None:
            PLANNER_COUNTS["programs"] += 1
        sp = obs.NOOP_SPAN
        if obs.enabled():
            obs.counter("exec.dispatches").inc()
            sp = obs.span(
                "exec.dispatch", route="sharded_multiway" if self.multiway else "sharded",
                round=self.rounds, count_only=self.count_only,
                est_join_rows=(list(self.planned.est_join_rows)
                               if self.planned is not None else None),
            )
        sig = self.plan_sig()
        run = run_sharded_conj
        if proflog.enabled():
            run = proflog.instrument("sharded", proflog.sig_digest(sig, self.count_only),
                                     run_sharded_conj,
                                     model_bytes=partial(program_model_bytes, sig, self.arrays))
        with sp, obs.annotation("exec.dispatch"):
            vals, valid, stats = run(sig, self.ex.mesh, self.arrays, self.keys, self.fvals)
        return (stats,) if self.count_only else (stats, *vals, *valid)

    def settle(self, host_out, dev_out) -> bool:
        """Consume one round's fetched outputs.  True = finished (result
        set, or None at the ceiling: the staged mesh pipeline answers);
        False = capacities grew, dispatch again."""
        from das_tpu_torch.planner import observe_settle
        from das_tpu_torch.query.compiler import ROUTE_COUNTS

        S = self.ex.mesh.n_local
        stats = host_out[0]
        if self.count_only:
            vals = valid = host_vals = host_valid = None
        else:
            host_vals, host_valid = np.stack(host_out[1:1 + S]), np.stack(host_out[1 + S:])
            vals, valid = list(dev_out[1:1 + S]), list(dev_out[1 + S:])
        n_terms, n_joins = len(self.sigs), len(self.join_caps)
        ranges = stats[3:3 + n_terms]
        jtotals = stats[3 + n_terms:3 + n_terms + n_joins]
        eoccs = stats[3 + n_terms + n_joins:]
        new_tc = tuple(_pow2_at_least(int(r)) if int(r) > c else c
                       for r, c in zip(ranges, self.term_caps))
        new_jc = tuple(_pow2_at_least(int(t)) if int(t) > c else c
                       for t, c in zip(jtotals, self.join_caps))
        new_ec = tuple((0 if c == 0 else (_pow2_at_least(int(o)) if int(o) > c else c))
                       for o, c in zip(eoccs, self.exch_caps))
        if (new_tc, new_jc, new_ec) != (self.term_caps, self.join_caps, self.exch_caps):
            if max(new_tc + new_jc + new_ec, default=0) > self.ex.db.config.max_result_capacity:
                return True  # the staged mesh pipeline owns the overflow policy
            self.term_caps, self.join_caps, self.exch_caps = new_tc, new_jc, new_ec
            return False
        self.ex._caps[self.sigs] = (self.term_caps, self.join_caps, self.exch_caps)
        self.last_ranges = [int(r) for r in ranges]
        self.last_join_rows = [int(t) for t in jtotals]
        if self.planned is not None:
            observe_settle(self.planned, self.last_join_rows, self.rounds, shards=S)
        count, reseed, pos_empty = int(stats[0]), bool(stats[1]), bool(stats[2])
        n_positive = sum(1 for s in self.sigs if not s.negated)
        self.result = ShardedFusedResult(
            var_names=self.names, vals=vals, valid=valid, count=count,
            reseed_needed=reseed or (
                count == 0 and n_positive > 1 and not pos_empty and not self.same_order),
            host_vals=host_vals, host_valid=host_valid, multiway=bool(self.multiway),
            stats=stats, rounds=self.rounds,
        )
        if self.multiway and self.count_route:
            ROUTE_COUNTS["sharded_multiway"] += 1
        return True


class _ShardedTreeExecJob(_TreeExecJob):
    """One whole-tree mesh job: query/fused.py _TreeExecJob with the mesh
    tree function (build_sharded_tree_fused), the per-shard output layout,
    the site block length (the exchange occupancies appended) and the
    sharded result class."""

    __slots__ = ()
    route = "sharded_tree_fused"

    def tree_sig(self) -> ShardedTreeSig:
        return ShardedTreeSig(
            tuple(j.plan_sig() for j in self.site_jobs),
            self.neg_job.plan_sig() if self.neg_job is not None else None,
        )

    def _build(self, tree_sig):
        fn, names = build_sharded_tree_fused(tree_sig, self.ex.mesh)
        return proflog.instrument("sharded_tree", proflog.sig_digest(tree_sig, False), fn,
                                  model_bytes=partial(tree_model_bytes, tree_sig)), names

    def _flatten(self, out):
        vals, valid, stats = out
        return (*vals, *valid, stats)

    def _unpack(self, flat, host: bool):
        """Per-shard lists on the device, stacked [S, ...] arrays on the
        host."""
        S = self.ex.mesh.n_local
        vals, valid, stats = list(flat[:S]), list(flat[S:2 * S]), flat[2 * S]
        if host:
            return np.stack(vals), np.stack(valid), stats
        return vals, valid, stats

    def _blk_len(self, j) -> int:
        return conj_stats_len(len(j.sigs), len(j.join_caps)) + len(j.exch_caps)

    def _make_result(self, vals, valid, count, host_vals, host_valid, stats):
        return ShardedFusedResult(var_names=self.names, vals=vals, valid=valid, count=count,
                                  reseed_needed=False, host_vals=host_vals,
                                  host_valid=host_valid, stats=stats, rounds=self.rounds)


def get_sharded_executor(db) -> ShardedFusedExecutor:
    """The store's executor, cached on its tables: a re-partition (which
    replaces them) drops it; a commit keeps it."""
    ex = getattr(db.tables, "_fused_executor", None)
    if ex is None or ex.db is not db:
        ex = ShardedFusedExecutor(db)
        db.tables._fused_executor = ex
    return ex
