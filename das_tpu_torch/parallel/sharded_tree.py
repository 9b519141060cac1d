"""The tree executor on the mesh (port of `das_tpu/parallel/sharded_tree.py`).

`ShardedTreeOps` plugs into the tree evaluator's op layer (query/tree.py
`TreeOps`): the same evaluator — the join condition matrix,
union/difference, negation filtering, the reseed quirk — runs with every
table's rows sharded.  A table is held as one [S*cap, k] tensor on the
mesh's first device whose block s (rows s*cap .. (s+1)*cap) belongs to
shard s: the row order of the JAX package's row-sharded global arrays, so
the evaluator's row-wise mask algebra runs on it unchanged.  The
cross-row combinators run block by block, each block on its slab's
device:

  * leaf probes — slab-local (each link lives on exactly one slab, so a
    leaf table has no duplicate across shards);
  * join — the right table gathered whole to every shard (or the left,
    when the accumulator is the smaller side), then the shard-local
    sort-merge join kernel;
  * dedup — shard-local only; duplicates across shards survive on the
    device and die in the host assignment set at materialization;
  * anti_join / difference — the tabu side is replicated first
    (`replicate`), since a row must go on whichever shard it lives;
  * counts — summed over the shards.

Only the one-device placement is tested: with slabs on several cards the
blocks travel between the first card and theirs."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from das_tpu_torch import kernels
from das_tpu_torch.core.exceptions import CapacityOverflowError
from das_tpu_torch.ops import composite as comp_ops
from das_tpu_torch.ops import posting
from das_tpu_torch.ops.join import dedup_table
from das_tpu_torch.parallel import mesh as M
from das_tpu_torch.query.plan import PUTermPlan
from das_tpu_torch.query.tree import CTable, TreeOps, _finish_uterm


class ShardedTreeOps(TreeOps):
    """The mesh op layer of the tree evaluator."""

    def __init__(self, db):
        super().__init__(db)
        self.mesh = db.mesh
        self.S = db.mesh.size
        #: the tables this layer probes (the store rebuilds the layer when
        #: a re-partition replaces them)
        self.tables = db.tables
        self.home = M.replicated(db.mesh)

    # -- layout ------------------------------------------------------------

    def _blocks(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A flat [S*cap, ...] table's per-shard blocks, on their devices."""
        return [b.contiguous().to(d) for b, d in
                zip(x.reshape(self.S, -1, *x.shape[1:]).unbind(0), self.mesh.devices)]

    def _flat(self, blocks) -> torch.Tensor:
        """Per-shard blocks as one flat table on the first device."""
        return torch.cat([b.to(self.home) for b in blocks], dim=0)

    def _per_shard(self, fn):
        out = []
        for s in range(self.S):
            with self.mesh.on_shard(s):
                out.append(fn(s))
        return out

    def _table(self, st) -> Optional[CTable]:
        if st is None or st.count == 0:
            return None
        return CTable(kind="O", onames=st.var_names, ocols=tuple(range(len(st.var_names))),
                      ugroups=(), vals=self._flat(st.vals), valid=self._flat(st.valid),
                      count=st.count)

    # -- leaves ------------------------------------------------------------

    def run_term(self, plan) -> Optional[CTable]:
        return self._table(self.db._term_table(plan))

    def conj(self, plans) -> Optional[CTable]:
        return self._table(self.db._run_conjunctive(plans))

    def run_uterm(self, plan: PUTermPlan) -> Optional[CTable]:
        """An unordered pattern probed slab by slab: every target position's
        posting window for the first required row (or the type or template
        window), deduplicated, the multiset verified, the sorted value
        blocks built; capacity retry on the worst slab's window."""
        sb = self.tables.buckets.get(plan.arity)
        if sb is None or sb.size == 0:
            return None
        arity = plan.arity
        required = tuple(plan.required)
        probe_type = -1
        if plan.ctype is not None:
            probes = [(sb.key_ctype, sb.order_by_ctype, int(plan.ctype))]
        elif required:
            v0 = int(required[0][0])
            if plan.type_id is not None:
                probe_type = int(plan.type_id)
                probes = [(sb.key_type_pos[p], sb.order_by_type_pos[p],
                           (int(plan.type_id) << 32) | v0) for p in range(arity)]
            else:
                probes = [(sb.key_pos[p], sb.order_by_pos[p], v0) for p in range(arity)]
        elif plan.type_id is not None:
            probes = [(sb.key_type, sb.order_by_type, int(plan.type_id))]
        else:
            probes = []   # the whole slab
        req_vals = np.asarray([v for v, c in required for _ in range(c)], dtype=np.int32)
        pair_vals = [v for v, _ in required]
        pair_cnts = [c for _, c in required]
        k = len(plan.var_names)
        cap = min(self.db.config.initial_result_capacity,
                  max(sb.m_local * max(1, len(probes)), 16))

        def probe(s, cap):
            t, ts, tc = sb.targets[s], sb.targets_sorted[s], sb.type_id[s]
            if not probes:
                local = torch.arange(t.shape[0], dtype=torch.int32, device=t.device)
                keep = tc != -1
                worst = torch.zeros((), dtype=torch.int32, device=t.device)
            else:
                wins = [posting.range_probe(ks[s], ps[s], key, cap) for ks, ps, key in probes]
                local, keep = posting.dedup_sorted(torch.cat([w[0] for w in wins]),
                                                   torch.cat([w[1] for w in wins]))
                worst = torch.stack([w[2] for w in wins]).max()
            mask = posting.verify_multiset_traced(t, tc, local, keep, probe_type, pair_vals,
                                                  pair_cnts, len(required))
            vals, mask = comp_ops.build_uterm_table(ts, local, mask, req_vals,
                                                    int(req_vals.size), k)
            return vals, mask, worst

        while True:
            outs = self._per_shard(lambda s: probe(s, cap))
            worst = int(M.pmax([o[2] for o in outs], self.mesh))
            if worst <= cap:
                break
            if cap >= self.db.config.max_result_capacity:
                raise CapacityOverflowError(
                    f"uterm probe needs {worst} rows > max_result_capacity")
            cap = min(max(cap * 2, worst), self.db.config.max_result_capacity)
        return _finish_uterm(self, plan, self._flat([o[0] for o in outs]),
                             self._flat([o[1] for o in outs]))

    # -- table combinators -------------------------------------------------

    def _gather_table(self, v, m):
        """A row-sharded flat table gathered whole to every shard in ONE
        tiled all_gather (validity packed into the value block)."""
        packed = [torch.cat([bv, bm[:, None].to(bv.dtype)], dim=1)
                  for bv, bm in zip(self._blocks(v), self._blocks(m))]
        fulls = M.all_gather(packed, self.mesh)
        return [f[:, :-1].contiguous() for f in fulls], [f[:, -1] != 0 for f in fulls]

    def join_tables(self, av, am, bv, bm, pairs, extra, cap, counts=None):
        """Broadcast-right: `b` gathered to every shard and joined against
        a's blocks.  When the accumulator is the smaller side, `a` is
        gathered instead, b's blocks stay local, and the joined columns are
        permuted back to the [a columns..., b extras...] layout (every a
        column is a join key or carried as an extra, so the permutation is
        total).  Returns (vals, valid, worst shard total)."""
        if counts is not None and counts[0] < counts[1]:
            n_a, n_b = av.shape[1], bv.shape[1]
            shared_a = {ac: bc for ac, bc in pairs}
            pairs_sw = tuple((bc, ac) for ac, bc in pairs)
            a_extra = tuple(c for c in range(n_a) if c not in shared_a)
            perm = [shared_a[c] if c in shared_a else n_b + a_extra.index(c)
                    for c in range(n_a)] + list(extra)
            a_full, am_full = self._gather_table(av, am)
            b_blocks, bm_blocks = self._blocks(bv), self._blocks(bm)
            outs = self._per_shard(lambda s: kernels.join_tables(
                b_blocks[s], bm_blocks[s], a_full[s], am_full[s], pairs_sw, a_extra, cap))
            outs = [(v[:, perm], m, t) for v, m, t in outs]
        else:
            b_full, bm_full = self._gather_table(bv, bm)
            a_blocks, am_blocks = self._blocks(av), self._blocks(am)
            outs = self._per_shard(lambda s: kernels.join_tables(
                a_blocks[s], am_blocks[s], b_full[s], bm_full[s], pairs, extra, cap))
        worst = int(M.pmax([o[2] for o in outs], self.mesh))
        return self._flat([o[0] for o in outs]), self._flat([o[1] for o in outs]), worst

    def dedup(self, vals, valid):
        """Shard-local dedup; the count is summed over the shards."""
        vb, mb = self._blocks(vals), self._blocks(valid)
        outs = self._per_shard(lambda s: dedup_table(vb[s], mb[s]))
        count = int(M.psum([o[2] for o in outs], self.mesh))
        return self._flat([o[0] for o in outs]), self._flat([o[1] for o in outs]), count

    def anti_join(self, lv, lm, rv, rm, pairs):
        """The tabu side arrives replicated (`replicate`), so removal is
        shard-local."""
        lb, mb = self._blocks(lv), self._blocks(lm)
        devs = self.mesh.devices
        return self._flat(self._per_shard(lambda s: kernels.anti_join(
            lb[s], mb[s], rv.to(devs[s]), rm.to(devs[s]), pairs)))

    def concat(self, parts):
        """Per-shard concatenation: block s of the result is every part's
        block s in order."""
        vb = [self._blocks(v) for v, _ in parts]
        mb = [self._blocks(m) for _, m in parts]
        vals = [torch.cat([b[s] for b in vb], dim=0) for s in range(self.S)]
        valid = [torch.cat([b[s] for b in mb], dim=0) for s in range(self.S)]
        return self._flat(vals), self._flat(valid)

    def replicate(self, t: CTable) -> CTable:
        """The table whole on every shard (one all_gather), held on the
        first device."""
        vals, valid = self._gather_table(t.vals, t.valid)
        return CTable(t.kind, t.onames, t.ocols, t.ugroups, vals[0], valid[0], t.count)
