"""Mesh-sharded AtomSpace backend (port of `das_tpu/parallel/sharded_db.py`).

The counterpart of the reference's Redis-cluster hash-slot sharding
(SURVEY.md §2.10): every link bucket's rows are dealt round-robin over
the mesh (row j of a bucket goes to slab j % S), and each slab holds its
own columns plus slab-local sorted probe indexes, capacity-padded to one
`m_local` for all slabs.  Local slab s lives on `mesh.devices[s]`
(parallel/mesh.py); several slabs may share a device.  A mesh may span
processes: each process deals the whole partition on the host and holds
its own slabs, and then only counts run (`get_sharded_executor(db)
.execute(plans, count_only=True)`); materializing answers, commits,
snapshots and trees raise NotImplementedError.

Conjunctions run on the fused sharded executor (parallel/fused_sharded.py);
what it declines replays on the staged pipeline here (`sharded_execute`):
slab-local probes, joins that gather the whole right table to every shard
(broadcast-right), anti-joins against the gathered negative table, the
counts summed over the shards.  Or trees of conjunctions, unordered links
and nesting run on the tree executor with the mesh op layer
(parallel/sharded_tree.py, `tree_ops`).  Every kernel call is shard-local:
one launch per slab per step.

A commit extends the slabs in place of their capacity slack
(`ShardedTables.stage_delta`): delta rows continue the round-robin,
slab-local indexes merge through `storage/delta.py merge_sorted_index`,
and a slab whose slack cannot take a commit raises `SlabCapacityExhausted`,
upon which the store re-partitions.  The rest of the DBInterface surface
is MemoryDB's (host scans)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from das_tpu_torch import kernels
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import CapacityOverflowError
from das_tpu_torch.parallel import mesh as M
from das_tpu_torch.query import compiler as qc
from das_tpu_torch.query.assignment import OrderedAssignment
from das_tpu_torch.query.ast import LogicalExpression, PatternMatchingAnswer
from das_tpu_torch.storage.atom_table import AtomSpaceData, Finalized
from das_tpu_torch.storage.delta import (
    FULL,
    NOOP,
    IncrementalCommitMixin,
    capacity_class,
    delta_class,
    merge_sorted_index,
)
from das_tpu_torch.storage.memory_db import MemoryDB

_I64_MAX = 2**63 - 1

#: per-slab columns and single sorted indexes, with their pad value
SLAB_FIELDS = (
    ("type_id", -1), ("ctype", _I64_MAX), ("targets", -2), ("targets_sorted", -2),
    ("key_type", _I64_MAX), ("order_by_type", 0), ("key_ctype", _I64_MAX),
    ("order_by_ctype", 0),
)
#: per-position sorted index families (one list entry per target position)
SLAB_POS_FIELDS = (
    ("key_type_pos", _I64_MAX), ("order_by_type_pos", 0), ("key_pos", _I64_MAX),
    ("order_by_pos", 0),
)


@dataclass
class ShardedBucket:
    """One arity's slabs, capacity-padded along the local axis: `m_local`
    holds ~6% slack beyond the largest slab's rows, so commits land in the
    slack without changing a tensor's shape.  Each field is a list over the
    shards (slab s on mesh.devices[s]); the positional families are one
    such list per target position."""

    arity: int
    n_shards: int
    m_local: int                   # padded local capacity
    size: int                      # real rows over all slabs
    slab_sizes: np.ndarray         # [S] real rows per slab (host)
    type_id: List[torch.Tensor]    # [m] int32, pad -1
    ctype: List[torch.Tensor]      # [m] int64
    targets: List[torch.Tensor]    # [m, a] int32, pad -2
    targets_sorted: List[torch.Tensor]
    key_type: List[torch.Tensor]   # [m] int64 sorted, pad int64 max
    order_by_type: List[torch.Tensor]
    key_ctype: List[torch.Tensor]
    order_by_ctype: List[torch.Tensor]
    key_type_pos: List[List[torch.Tensor]]
    order_by_type_pos: List[List[torch.Tensor]]
    key_pos: List[List[torch.Tensor]]
    order_by_pos: List[List[torch.Tensor]]

    def host(self) -> Dict[str, np.ndarray]:
        """Every field stacked over the shards on the host: [S, m_local, ...]
        arrays, positional families as `<name><pos>` (the checkpoint
        layout)."""
        out = {}
        for name, _ in SLAB_FIELDS:
            out[name] = np.stack([t.cpu().numpy() for t in getattr(self, name)])
        for name, _ in SLAB_POS_FIELDS:
            for p, slabs in enumerate(getattr(self, name)):
                out[f"{name}{p}"] = np.stack([t.cpu().numpy() for t in slabs])
        return out

    def nbytes_per_slab(self) -> List[int]:
        """Bytes of each of this process's slabs."""
        per = [0] * len(self.type_id)
        for name, _ in SLAB_FIELDS:
            for s, t in enumerate(getattr(self, name)):
                per[s] += t.numel() * t.element_size()
        for name, _ in SLAB_POS_FIELDS:
            for slabs in getattr(self, name):
                for s, t in enumerate(slabs):
                    per[s] += t.numel() * t.element_size()
        return per


def bucket_from_host(arity: int, m_local: int, size: int, slab_sizes: np.ndarray,
                     arrays: Dict[str, np.ndarray], mesh: M.Mesh) -> ShardedBucket:
    """Upload this process's slabs of a bucket's stacked host arrays
    (`ShardedBucket.host` layout, one [m_local, ...] entry per global
    shard), each onto its slab's device."""
    fields = {name: M.shard_put(arrays[name], mesh) for name, _ in SLAB_FIELDS}
    for name, _ in SLAB_POS_FIELDS:
        fields[name] = [M.shard_put(arrays[f"{name}{p}"], mesh) for p in range(arity)]
    return ShardedBucket(arity=arity, n_shards=mesh.size, m_local=m_local, size=size,
                         slab_sizes=np.asarray(slab_sizes, dtype=np.int32), **fields)


def _build_sharded_bucket(b, mesh: M.Mesh) -> ShardedBucket:
    """Deal one finalized LinkBucket round-robin over the mesh and build the
    slab-local stable-argsort probe indexes.  Every process deals the whole
    partition on the host (the host records are replicated) and uploads
    its own slabs."""
    S = mesh.size
    arity, m = b.arity, b.size
    m_local = capacity_class(max(1, -(-m // S)))
    slabs = [np.arange(s, m, S, dtype=np.int64) for s in range(S)]

    def padded(build, fill, dtype, extra_shape=()):
        out = np.full((S, m_local, *extra_shape), fill, dtype=dtype)
        for s, rows in enumerate(slabs):
            out[s, : len(rows)] = build(rows)
        return out

    def sorted_index(keys_of):
        key_arr = np.full((S, m_local), _I64_MAX, dtype=np.int64)
        ord_arr = np.zeros((S, m_local), dtype=np.int32)
        for s, rows in enumerate(slabs):
            k = keys_of(rows).astype(np.int64)
            o = np.argsort(k, kind="stable")
            key_arr[s, : len(rows)] = k[o]
            ord_arr[s, : len(rows)] = o
        return key_arr, ord_arr

    arrays = {
        "type_id": padded(lambda r: b.type_id[r], -1, np.int32),
        "ctype": padded(lambda r: b.ctype[r], _I64_MAX, np.int64),
        "targets": padded(lambda r: b.targets[r], -2, np.int32, (arity,)),
        "targets_sorted": padded(lambda r: b.targets_sorted[r], -2, np.int32, (arity,)),
    }
    arrays["key_type"], arrays["order_by_type"] = sorted_index(lambda r: b.type_id[r])
    arrays["key_ctype"], arrays["order_by_ctype"] = sorted_index(lambda r: b.ctype[r])
    for p in range(arity):
        arrays[f"key_type_pos{p}"], arrays[f"order_by_type_pos{p}"] = sorted_index(
            lambda r, p=p: (b.type_id[r].astype(np.int64) << 32) | b.targets[r, p].astype(np.int64))
        arrays[f"key_pos{p}"], arrays[f"order_by_pos{p}"] = sorted_index(
            lambda r, p=p: b.targets[r, p])
    sizes = np.array([len(r) for r in slabs], dtype=np.int32)
    return bucket_from_host(arity, m_local, m, sizes, arrays, mesh)


class SlabCapacityExhausted(Exception):
    """A commit no longer fits a slab's slack: the store re-partitions."""


def _insert_rows(col: torch.Tensor, block: torch.Tensor, n: int) -> torch.Tensor:
    """A copy of `col` with `block` written at row n (the live slab is never
    written)."""
    out = col.clone()
    out[n:n + block.shape[0]] = block
    return out


class ShardedTables:
    """Every arity's slabs over one mesh."""

    def __init__(self, fin: Finalized, mesh: M.Mesh):
        self.mesh = mesh
        self.n_shards = mesh.size
        self.buckets: Dict[int, ShardedBucket] = {
            arity: _build_sharded_bucket(b, mesh) for arity, b in fin.buckets.items()
        }
        #: True when built from a sharded checkpoint's saved slabs
        self.restored = False

    @classmethod
    def from_buckets(cls, buckets: Dict[int, ShardedBucket], mesh: M.Mesh) -> "ShardedTables":
        """The slabs of a sharded checkpoint, ready-made (no re-partition)."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.n_shards = mesh.size
        self.buckets = buckets
        self.restored = True
        return self

    def nbytes_per_slab(self) -> List[int]:
        per = [0] * self.mesh.n_local
        for b in self.buckets.values():
            for s, n in enumerate(b.nbytes_per_slab()):
                per[s] += n
        return per

    def stage_delta(self, delta):
        """Compute one arity's slab extension by a commit bucket and return
        (swap, became_base, slots): the merged bucket becomes visible only
        when `swap` runs (storage/delta.py _apply_delta), so a failure while
        staging, SlabCapacityExhausted included, leaves `buckets` as it was.
        One process only (`Mesh.require_one_process`).

        Delta row j goes to slab (size + j) % S, continuing the round-robin,
        into positions slab_sizes[s].. of its slack; each slab-local sorted
        index merges its slab's sorted delta in O(m_local)."""
        self.mesh.require_one_process("a commit")
        arity, d = delta.arity, delta.size
        base = self.buckets.get(arity)
        if base is None or base.size == 0:
            built = _build_sharded_bucket(delta, self.mesh)

            def swap_base():
                self.buckets[arity] = built

            return swap_base, True, d
        S, m_local = self.n_shards, base.m_local
        js = [[j for j in range(d) if (base.size + j) % S == s] for s in range(S)]
        dcap = delta_class(max(len(x) for x in js))
        if int(base.slab_sizes.max()) + dcap > m_local:
            raise SlabCapacityExhausted(
                f"arity-{arity} slab slack exhausted "
                f"({int(base.slab_sizes.max())}+{dcap} > {m_local})")
        def d_padded(col, fill, dtype, extra_shape=()):
            out = np.full((S, dcap, *extra_shape), fill, dtype=dtype)
            for s, rows in enumerate(js):
                out[s, : len(rows)] = col[rows]
            return M.shard_put(out, self.mesh)

        def d_sorted(keys_of):
            key_arr = np.full((S, dcap), _I64_MAX, dtype=np.int64)
            perm_arr = np.zeros((S, dcap), dtype=np.int32)
            for s, rows in enumerate(js):
                k = keys_of(np.array(rows, dtype=np.int64)).astype(np.int64)
                o = np.argsort(k, kind="stable")
                key_arr[s, : len(rows)] = k[o]
                # the i-th delta row of slab s sits at slab_sizes[s] + i
                perm_arr[s, : len(rows)] = base.slab_sizes[s] + o.astype(np.int32)
            return M.shard_put(key_arr, self.mesh), M.shard_put(perm_arr, self.mesh)

        def merged(bk, bo, dk, do):
            keys, perm = [], []
            for s in range(S):
                with self.mesh.on_shard(s):
                    k, o = merge_sorted_index(bk[s], bo[s], dk[s], do[s])
                keys.append(k[:m_local])
                perm.append(o[:m_local])
            return keys, perm

        fields = {}
        for name, fill, dtype, extra in (
                ("type_id", -1, np.int32, ()), ("ctype", _I64_MAX, np.int64, ()),
                ("targets", -2, np.int32, (arity,)), ("targets_sorted", -2, np.int32, (arity,))):
            block = d_padded(getattr(delta, name), fill, dtype, extra)
            fields[name] = [_insert_rows(getattr(base, name)[s], block[s],
                                         int(base.slab_sizes[s])) for s in range(S)]
        fields["key_type"], fields["order_by_type"] = merged(
            base.key_type, base.order_by_type, *d_sorted(lambda r: delta.type_id[r]))
        fields["key_ctype"], fields["order_by_ctype"] = merged(
            base.key_ctype, base.order_by_ctype, *d_sorted(lambda r: delta.ctype[r]))
        for name in ("key_type_pos", "order_by_type_pos", "key_pos", "order_by_pos"):
            fields[name] = []
        for p in range(arity):
            k, o = merged(base.key_type_pos[p], base.order_by_type_pos[p], *d_sorted(
                lambda r, p=p: (delta.type_id[r].astype(np.int64) << 32)
                | delta.targets[r, p].astype(np.int64)))
            fields["key_type_pos"].append(k)
            fields["order_by_type_pos"].append(o)
            k, o = merged(base.key_pos[p], base.order_by_pos[p],
                          *d_sorted(lambda r, p=p: delta.targets[r, p]))
            fields["key_pos"].append(k)
            fields["order_by_pos"].append(o)
        merged_bucket = ShardedBucket(
            arity=arity, n_shards=S, m_local=m_local, size=base.size + d,
            slab_sizes=base.slab_sizes + np.array([len(x) for x in js], dtype=np.int32),
            **fields)

        def swap():
            self.buckets[arity] = merged_bucket

        return swap, False, d


@dataclass
class ShardedTable:
    """A binding table held row-sharded: one [cap, k] block per shard."""

    var_names: Tuple[str, ...]
    vals: List[torch.Tensor]
    valid: List[torch.Tensor]
    count: int                                # exact rows over all shards
    host_vals: Optional[np.ndarray] = None    # [S, cap, k] fetched with the stats
    host_valid: Optional[np.ndarray] = None


class ShardedDB(IncrementalCommitMixin, MemoryDB):
    """MemoryDB surface plus conjunctions, trees and commits on the mesh.

    `mesh` as in das_tpu; without one, S = prod(config.mesh_shape) shards
    (one per card at hand when mesh_shape is None) go on the CUDA cards,
    or all on `device` when it is given (the tests pass "cpu")."""

    def __init__(self, data: Optional[AtomSpaceData] = None,
                 config: Optional[DasConfig] = None, device=None,
                 mesh: Optional[M.Mesh] = None):
        super().__init__(data)
        self.config = config or DasConfig()
        self.fin: Finalized = self.data.finalize()
        if mesh is None:
            shape = self.config.mesh_shape
            mesh = M.make_mesh(None if shape is None else int(np.prod(shape)), device=device)
        self.mesh = mesh
        #: where replicated values (stats, gathered tables) live
        self.device = M.replicated(mesh)
        tables = None
        if self.config.checkpoint_path:
            # shard-local restore: upload the saved slabs instead of
            # re-partitioning the host-global Finalized
            from das_tpu_torch.storage import checkpoint

            tables = checkpoint.try_restore_sharded(self.config.checkpoint_path, self.fin,
                                                    self.mesh)
        self.tables = tables or ShardedTables(self.fin, self.mesh)
        self._reset_delta_state()

    def __repr__(self):
        return f"<ShardedDB over {self.tables.n_shards} shards>"

    def refresh(self) -> None:
        """Re-sync the slabs after commits: a small delta extends them in
        their slack (`ShardedTables.stage_delta`); past
        delta_merge_threshold, or where a delta is unsafe, the store
        re-finalizes and re-partitions (which replaces `tables` and with it
        the executor and its caches)."""
        self.prefetch()
        action = self._plan_refresh()
        if action == NOOP:
            return
        self.mesh.require_one_process("a commit")
        if action == FULL:
            wal = self._wal
            if wal is not None:
                wal.append(self.data, self.delta_version + 1, kind="full")
            self.fin = self.data.finalize()
            self.tables = ShardedTables(self.fin, self.mesh)
            self._reset_delta_state()
            return
        self._commit_delta_with_retry(action)

    @classmethod
    def restore(cls, path: str, config: Optional[DasConfig] = None,
                device=None) -> "ShardedDB":
        """The newest valid snapshot generation under `path` with its WAL
        replayed (storage/durable.py restore); the saved slabs are uploaded
        directly when the shard count and content still match."""
        from das_tpu_torch.storage import durable

        return durable.restore(path, config=config, backend="sharded", device=device)

    def _stage_delta_merge(self, commit_bucket):
        return self.tables.stage_delta(commit_bucket)

    def _commit_delta_with_retry(self, action) -> None:
        try:
            super()._commit_delta_with_retry(action)
        except SlabCapacityExhausted:
            # the aborted commit staged but never swapped, so the
            # re-partition starts from the pre-commit tables
            self.fin = self.data.finalize()
            self.tables = ShardedTables(self.fin, self.mesh)
            self._reset_delta_state()

    def _type_id(self, link_type: str) -> Optional[int]:
        h = self.data.table.get_named_type_hash(link_type)
        return self.fin.type_id_of_hash.get(h)

    # -- the staged pipeline ---------------------------------------------------

    def _term_table(self, plan: qc.TermPlan) -> Optional[ShardedTable]:
        """One term probed on every slab (one probe launch a slab), with a
        capacity retry on the worst slab's range."""
        sb = self.tables.buckets.get(plan.arity)
        if sb is None:
            return None
        if plan.ctype is not None:
            key_sorted, perm, probe_key, fixed = sb.key_ctype, sb.order_by_ctype, plan.ctype, ()
        elif plan.type_id is not None and plan.fixed:
            p0, v0 = plan.fixed[0]
            key_sorted, perm = sb.key_type_pos[p0], sb.order_by_type_pos[p0]
            probe_key, fixed = (int(plan.type_id) << 32) | int(v0), tuple(plan.fixed[1:])
        else:
            key_sorted, perm, probe_key, fixed = sb.key_type, sb.order_by_type, plan.type_id, ()
        extra = tuple(p for p, _ in fixed)
        fvals = [v for _, v in fixed]
        mesh = self.mesh
        cap = min(self.config.initial_result_capacity, max(sb.m_local, 16))
        while True:
            vals, mask, rngs = [], [], []
            for s in range(mesh.n_local):
                with mesh.on_shard(s):
                    v, m, r = kernels.probe_term_table(
                        key_sorted[s], perm[s], sb.targets[s], int(probe_key), fvals, cap,
                        var_cols=plan.var_cols, eq_pairs=plan.eq_pairs, extra_fixed=extra)
                vals.append(v)
                mask.append(m)
                rngs.append(r)
            worst = int(M.pmax(rngs, mesh))
            if worst <= cap:
                count = int(M.psum([m.sum() for m in mask], mesh))
                if count == 0:
                    return None
                return ShardedTable(plan.var_names, vals, mask, count)
            if cap >= self.config.max_result_capacity:
                raise CapacityOverflowError(
                    f"probe needs {worst} rows > max_result_capacity "
                    f"{self.config.max_result_capacity}")
            cap = min(max(cap * 2, worst), self.config.max_result_capacity)

    def _join(self, left: ShardedTable, right: ShardedTable) -> ShardedTable:
        """Broadcast-right: the whole right table gathered to every shard,
        joined against the resident left slab."""
        pairs = tuple((left.var_names.index(v), right.var_names.index(v))
                      for v in left.var_names if v in right.var_names)
        extra = tuple(i for i, v in enumerate(right.var_names) if v not in left.var_names)
        out_names = left.var_names + tuple(v for v in right.var_names if v not in left.var_names)
        mesh = self.mesh
        rv_full = M.all_gather(right.vals, mesh)
        rm_full = M.all_gather(right.valid, mesh)
        cap = max(64, min(left.count * right.count, self.config.initial_result_capacity))
        while True:
            vals, valid, totals = [], [], []
            for s in range(mesh.n_local):
                with mesh.on_shard(s):
                    v, m, t = kernels.join_tables(left.vals[s], left.valid[s], rv_full[s],
                                                  rm_full[s], pairs, extra, cap)
                vals.append(v)
                valid.append(m)
                totals.append(t)
            worst = int(M.pmax(totals, mesh))
            if worst <= cap:
                count = int(M.psum([m.sum() for m in valid], mesh))
                return ShardedTable(out_names, vals, valid, count)
            if cap >= self.config.max_result_capacity:
                raise CapacityOverflowError(
                    f"join needs {worst} rows > max_result_capacity "
                    f"{self.config.max_result_capacity}")
            cap = min(max(cap * 2, worst), self.config.max_result_capacity)

    def _anti_join(self, left: ShardedTable, tabu: ShardedTable) -> ShardedTable:
        """The negative table gathered to every shard, filtering each slab."""
        pairs = tuple((left.var_names.index(v), tabu.var_names.index(v))
                      for v in tabu.var_names)
        mesh = self.mesh
        rv_full = M.all_gather(tabu.vals, mesh)
        rm_full = M.all_gather(tabu.valid, mesh)
        valid = []
        for s in range(mesh.n_local):
            with mesh.on_shard(s):
                valid.append(kernels.anti_join(left.vals[s], left.valid[s], rv_full[s],
                                               rm_full[s], pairs))
        count = int(M.psum([m.sum() for m in valid], mesh))
        return ShardedTable(left.var_names, left.vals, valid, count)

    def sharded_execute(self, plans: List[qc.TermPlan]) -> Optional[ShardedTable]:
        """The staged mesh pipeline in reference order, reseed quirk
        included: each term probed, each positive joined onto the
        accumulator (an empty accumulator is replaced by the next term),
        the negatives filtering at the end."""
        tabu: List[ShardedTable] = []
        accumulated: Optional[ShardedTable] = None
        for plan in plans:
            table = self._term_table(plan)
            if plan.negated:
                if table is not None:
                    tabu.append(table)
                continue
            if table is None:
                return None
            if accumulated is None or accumulated.count == 0:
                accumulated = table
            else:
                accumulated = self._join(accumulated, table)
        if accumulated is None:
            return None
        for t in tabu:
            if set(t.var_names) <= set(accumulated.var_names):
                accumulated = self._anti_join(accumulated, t)
        return accumulated

    def materialize(self, table: Optional[ShardedTable], answer: PatternMatchingAnswer) -> bool:
        """The table's valid rows as reference assignments (the host set
        removes duplicates across shards).  One process only: the other
        processes hold the other rows."""
        self.mesh.require_one_process("materializing answers")
        if table is None or table.count == 0:
            return False
        if table.host_vals is not None:
            vals, valid = table.host_vals, table.host_valid
        else:
            from das_tpu_torch.query.fused import fetch_many

            host = fetch_many([tuple(table.vals) + tuple(table.valid)])[0]
            S = len(table.vals)
            vals, valid = np.stack(host[:S]), np.stack(host[S:])
        vals = np.asarray(vals).reshape(-1, len(table.var_names))
        valid = np.asarray(valid).reshape(-1)
        hexes = self.fin.hex_of_row
        seen = set()
        for row in vals[valid]:
            key = tuple(int(v) for v in row)
            if key in seen:
                continue
            seen.add(key)
            a = OrderedAssignment()
            ok = True
            for name, val in zip(table.var_names, row):
                if not a.assign(name, hexes[int(val)]):
                    ok = False
                    break
            if ok and a.freeze():
                answer.assignments.add(a)
        return bool(answer.assignments)

    def _run_conjunctive(self, plans: List[qc.TermPlan]) -> Optional[ShardedTable]:
        """One conjunction on the mesh: the fused sharded executor (with the
        result cache), and what it declines (reseed, capacity ceiling) on
        the staged pipeline, with the same answers."""
        from das_tpu_torch.parallel.fused_sharded import get_sharded_executor

        res = get_sharded_executor(self).execute(plans, use_cache=True)
        if res is not None and not res.reseed_needed:
            return ShardedTable(res.var_names, res.vals, res.valid, res.count,
                                host_vals=res.host_vals, host_valid=res.host_valid)
        return self.sharded_execute(plans)

    def _or_branch_plans(self, query) -> Optional[List[List[qc.TermPlan]]]:
        """Plans of every branch of an all-positive Or of compilable
        conjunctions (a branch grounded on an absent atom is skipped), or
        None."""
        from das_tpu_torch.query.ast import Not, Or

        if not isinstance(query, Or) or not query.terms:
            return None
        if any(isinstance(t, Not) for t in query.terms):
            return None
        branch_plans = []
        for term in query.terms:
            plans = qc.plan_query(self, term, unknown_atom_empty=True)
            if plans is qc.EMPTY_PLAN:
                continue
            if plans is None:
                return None
            branch_plans.append(plans)
        return branch_plans

    @property
    def tree_ops(self):
        """The mesh op layer of the tree executor, rebuilt whenever `tables`
        is replaced (a re-partition)."""
        self.mesh.require_one_process("the tree executor")
        ops = getattr(self, "_tree_ops", None)
        if ops is None or ops.tables is not self.tables:
            from das_tpu_torch.parallel.sharded_tree import ShardedTreeOps

            ops = ShardedTreeOps(self)
            self._tree_ops = ops
        return ops

    def query_sharded(self, query: LogicalExpression,
                      answer: PatternMatchingAnswer) -> Optional[bool]:
        """Run a query on the mesh; None when it is outside the compiled
        language (the host algebra answers).

        A conjunction runs on `_run_conjunctive`; an all-positive Or of
        conjunctions first tries the whole-tree job, then runs each branch
        and unions the assignment sets; every other tree runs on the tree
        executor with the mesh op layer.  A CapacityOverflowError
        propagates to the router (compiler.dispatch), which answers on the
        host, as for the single-device store; any other error propagates."""
        from das_tpu_torch.query import assignment as asn_mod
        from das_tpu_torch.query import tree as tree_mod
        from das_tpu_torch.query.plan import NotCompilable, build_plan

        plans = qc.plan_query(self, query)
        if plans is not None:
            return self.materialize(self._run_conjunctive(plans), answer)
        branch_plans = self._or_branch_plans(query)
        if branch_plans is not None:
            if tree_mod.tree_fusion_enabled(self.config) and not asn_mod.CONFIG.get("no_overload"):
                try:
                    node = build_plan(self, query)
                except NotCompilable:
                    node = None
                if node is not None:
                    matched = tree_mod.query_tree_fused(self, node, answer,
                                                        tree_mod.tree_cache(self))
                    if matched is not None:
                        return matched
            matched = False
            for plans in branch_plans:
                matched = self.materialize(self._run_conjunctive(plans), answer) or matched
            return matched
        return tree_mod.query_tree(self, query, answer)
