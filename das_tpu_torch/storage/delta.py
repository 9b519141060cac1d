"""Incremental commits into the device store (port of
`das_tpu/storage/delta.py`).

A transaction commit does not re-finalize and re-upload the whole store.
It interns only the new atoms into the live `Finalized` registries,
columnizes them into a small bucket per arity, and merges each
capacity-padded sorted posting index on the device in O(n): merge-path
positions from |delta| binary searches into the base plus one cumsum, no
re-sort (`merge_sorted_index`).

The host part lives here (`IncrementalCommitMixin`): whether a delta is
safe (`_plan_refresh`), interning (`_intern_delta`), the delta
incoming-set overlay read by `get_incoming`, and the stage-then-swap
commit (`_apply_delta`).  The device merge is the backend's
(`storage/tensor_db.py _stage_delta_merge`).  Deltas accumulate
LSM-style; past `config.delta_merge_threshold` new atoms the store is
fully re-finalized and the overlay cleared.

Under a snapshot root (storage/durable.py) `_apply_delta` appends the
interned delta to the write-ahead log after every arity is staged and
before the first swap; with no root `_wal` is the class attribute None
and the commit path is unchanged.

`fault.maybe_fail("commit_apply")` marks the crash point between staging
and the swap, and `_commit_delta_with_retry` runs a commit through
`fault.commit_retry()`: stage-then-swap makes a failed attempt invisible,
so a retry re-stages the same commit.  `commit.delta` / `commit.rebuild`
are the obs/ events and counters of each version bump.

On a columnar store (storage/columnar.py) a commit's own membership probes
take the linear digest scan; after the first commit lands, the digest
indexes are built on a background thread for every later one."""

from __future__ import annotations

from itertools import islice
from typing import Dict, List

import torch

#: sentinel returned by _plan_refresh when only a full rebuild is safe
FULL = "full"
#: sentinel returned by _plan_refresh when nothing changed
NOOP = "noop"


def capacity_class(n: int) -> int:
    """Device-bucket capacity for n real rows: ~6% slack (min 64) absorbs
    commits without changing tensor shapes; deterministic, as in the JAX
    store."""
    return n + max(64, n >> 4)


def delta_class(d: int) -> int:
    """Power-of-two size class (min 64) of a commit's padded delta block."""
    return max(64, 1 << (d - 1).bit_length()) if d > 1 else 64


def merge_sorted_index(base_keys: torch.Tensor, base_perm: torch.Tensor,
                       delta_keys: torch.Tensor, delta_perm: torch.Tensor):
    """Extend a sorted index by a small sorted delta in O(n): merge-path
    positions from |delta| binary searches into the base plus one cumsum
    over the base, no re-sort of the big side.  Ties place base elements
    first (right-side search), preserving stability.  delta_perm must
    already be offset into the merged row space.  Positions and sums are
    int32, as the JAX package computes them.  Returns new tensors; the
    inputs are never written."""
    nb, nd = base_keys.shape[0], delta_keys.shape[0]
    dev = base_keys.device
    ins = torch.searchsorted(base_keys, delta_keys, right=True).to(torch.int32)
    counts = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, ins.long(), torch.ones(nd, dtype=torch.int32, device=dev))
    shift = torch.cumsum(counts, 0, dtype=torch.int32)[:nb]   # deltas at or before i
    pos_b = (torch.arange(nb, dtype=torch.int32, device=dev) + shift).long()
    pos_d = (ins + torch.arange(nd, dtype=torch.int32, device=dev)).long()
    keys = torch.zeros(nb + nd, dtype=base_keys.dtype, device=dev)
    keys[pos_b] = base_keys
    keys[pos_d] = delta_keys
    perm = torch.zeros(nb + nd, dtype=torch.int32, device=dev)
    perm[pos_b] = base_perm
    perm[pos_d] = delta_perm
    return keys, perm


class IncrementalCommitMixin:
    """Host-side delta-commit state of a device backend.

    Expects the host class to provide `self.data` (AtomSpaceData),
    `self.fin` (the live Finalized), `self.config` (DasConfig) and
    `_stage_delta_merge(bucket)`."""

    #: the write-ahead log (storage/durable.py DeltaLog) and the snapshot
    #: root it belongs to, set on the instance by durable.attach /
    #: write_snapshot / restore; None = no durability
    _wal = None
    _snapshot_root = None

    def _reset_delta_state(self) -> None:
        # the commit counter: bumps on every device-table change (full
        # rebuilds here, incremental commits in _apply_delta).  The result
        # cache and the planner's statistics key on it.
        self.delta_version = getattr(self, "delta_version", 0) + 1
        from das_tpu_torch import obs

        if obs.enabled():
            obs.event("commit.rebuild", version=self.delta_version)
            obs.counter("commit.rebuilds").inc()
        self._base_counts = (len(self.data.nodes), len(self.data.links))
        self._delta_incoming: Dict[int, list] = {}  # target_row -> [link_rows]
        self._delta_total = 0
        # backend-LOCAL view of the finalized buckets: several backends may
        # share one Finalized, and each backend's delta segments must pair
        # with the base its own device tables were built from
        self._base_buckets: Dict[int, object] = dict(self.fin.buckets)
        self._host_delta: Dict[int, list] = {}  # arity -> overlay segments

    def host_bucket_segments(self, arity: int):
        """Host column segments: this backend's base bucket plus one overlay
        segment per incremental commit.  Their concatenation, in order,
        mirrors the merged device row space (estimates, host counts)."""
        out = []
        base = self._base_buckets.get(arity)
        if base is not None and base.size:
            out.append(base)
        out.extend(self._host_delta.get(arity, ()))
        return out

    def _plan_refresh(self):
        """Classify the pending host mutations: NOOP (nothing changed),
        FULL (only a rebuild is safe), or the (new_node_hexes,
        new_link_hexes) of an applicable incremental commit."""
        n_nodes, n_links = len(self.data.nodes), len(self.data.links)
        d_nodes = n_nodes - self._base_counts[0]
        d_links = n_links - self._base_counts[1]
        if d_nodes == 0 and d_links == 0:
            return NOOP
        if (
            d_nodes < 0
            or d_links < 0
            or self.fin.atom_count == 0  # bulk load onto an empty store
            or self._delta_total + d_nodes + d_links > self.config.delta_merge_threshold
        ):
            return FULL
        new_node_hexes = list(islice(reversed(self.data.nodes), d_nodes))[::-1]
        new_link_hexes = list(islice(reversed(self.data.links), d_links))[::-1]
        dangled_on = self.fin.dangling_hexes
        if dangled_on is None:
            # sentinel targets with no recorded set: the commit cannot be
            # proven safe, so rebuild once
            return FULL
        if dangled_on and any(h in dangled_on for h in (*new_node_hexes, *new_link_hexes)):
            # an existing link's sentinel (-1) target just materialized;
            # sorted positional indexes cannot be patched in place
            return FULL
        return new_node_hexes, new_link_hexes

    def _intern_type(self, named_type_hash: str, named_type: str) -> int:
        tid = self.fin.type_id_of_hash.get(named_type_hash)
        if tid is None:
            tid = len(self.fin.type_names)
            self.fin.type_id_of_hash[named_type_hash] = tid
            self.fin.type_names.append(named_type)
        return tid

    def _intern_delta(self, new_node_hexes: List[str],
                      new_link_hexes: List[str]) -> Dict[int, list]:
        """Append the new atoms to the live row registries (nodes first,
        then links bucket-major) and return the new link records grouped
        by arity.

        Idempotent across backends that share one Finalized: only atoms
        beyond `fin.interned` are appended, so a backend whose device
        tables lag behind still gets its whole delta in the grouping but
        never re-interns rows another backend registered."""
        fin = self.fin
        if fin.interned is None:
            fin.interned = [fin.node_count, fin.atom_count - fin.node_count]
        n_nodes_new = len(self.data.nodes) - fin.interned[0]
        n_links_new = len(self.data.links) - fin.interned[1]
        # the registry's missing tail is a suffix of the new hexes (the
        # trailing entries of the insertion-ordered record dicts)
        to_intern_nodes = (new_node_hexes[len(new_node_hexes) - n_nodes_new:]
                           if n_nodes_new > 0 else [])
        to_intern_links = (new_link_hexes[len(new_link_hexes) - n_links_new:]
                           if n_links_new > 0 else [])
        for h in to_intern_nodes:
            rec = self.data.nodes[h]
            self._intern_type(rec.named_type_hash, rec.named_type)
            fin.row_of_hex[h] = len(fin.hex_of_row)
            fin.hex_of_row.append(h)
        intern_by_arity: Dict[int, list] = {}
        for h in to_intern_links:
            rec = self.data.links[h]
            intern_by_arity.setdefault(len(rec.elements), []).append((h, rec))
        for arity in sorted(intern_by_arity):
            for h, _rec in intern_by_arity[arity]:
                fin.row_of_hex[h] = len(fin.hex_of_row)
                fin.hex_of_row.append(h)
        fin.atom_count = len(fin.hex_of_row)
        fin.interned = [len(self.data.nodes), len(self.data.links)]
        # the device merge needs ALL of this backend's new links
        by_arity: Dict[int, list] = {}
        for h in new_link_hexes:
            rec = self.data.links[h]
            by_arity.setdefault(len(rec.elements), []).append((h, rec))
        return by_arity

    def _record_delta_incoming(self, incoming_pairs) -> None:
        """incoming_pairs: (target_rows, link_rows) array chunks from
        build_bucket."""
        for trows, lrows in incoming_pairs:
            for trow, lrow in zip(trows.tolist(), lrows.tolist()):
                self._delta_incoming.setdefault(trow, []).append(lrow)

    def _apply_delta(self, new_node_hexes: List[str], new_link_hexes: List[str]) -> None:
        """One incremental commit, stage then swap: intern the atoms
        (idempotent), columnize each arity's new links, and compute every
        device merge through `_stage_delta_merge`, which returns (swap,
        became_base, slots) and writes no live tensor.  Only after every
        arity staged do the swaps, the incoming-overlay updates and the
        `delta_version` bump run, so a failure while staging leaves the
        device tables, the version and every cached answer as they were,
        and re-running the same commit succeeds.  `maybe_fail("commit_apply")`
        marks the crash point between the halves."""
        from das_tpu_torch import fault
        from das_tpu_torch.storage.atom_table import build_bucket

        fin = self.fin
        by_arity = self._intern_delta(new_node_hexes, new_link_hexes)
        # -- stage: no visible change ---------------------------------------
        staged = []
        for arity, entries in sorted(by_arity.items()):
            incoming_pairs: list = []
            commit_bucket = build_bucket(arity, entries, fin.row_of_hex, self._intern_type,
                                         incoming_pairs, fin.dangling_hexes)
            swap, became_base, slots = self._stage_delta_merge(commit_bucket)
            staged.append((arity, commit_bucket, incoming_pairs, swap, became_base, slots))
        fault.maybe_fail("commit_apply")
        # -- write-ahead log: the interned delta is framed and fsynced
        # before anything becomes visible; a failed append leaves the store
        # as it was, and replay skips a retried commit's twin by version
        wal = self._wal
        if wal is not None:
            wal.append(self.data, self.delta_version + 1)
        # -- swap: assignments only -----------------------------------------
        slot_growth = 0
        for arity, commit_bucket, incoming_pairs, swap, became_base, slots in staged:
            swap()
            self._record_delta_incoming(incoming_pairs)
            slot_growth += slots
            if became_base:
                # first links of this arity: the delta bucket is this
                # backend's base (fin.buckets may be shared)
                self._base_buckets[arity] = commit_bucket
            else:
                self._host_delta.setdefault(arity, []).append(commit_bucket)
        self._base_counts = (len(self.data.nodes), len(self.data.links))
        self._delta_total += max(slot_growth, len(new_node_hexes) + len(new_link_hexes))
        # answers cached against the pre-commit version stop hitting
        self.delta_version += 1
        from das_tpu_torch import obs

        if obs.enabled():
            obs.event("commit.delta", version=self.delta_version,
                      nodes=len(new_node_hexes), links=len(new_link_hexes))
            obs.counter("commit.deltas").inc()
        if self.data.columnar is not None:
            # more commits (and their membership probes) are likely: build
            # the digest indexes now; this commit kept its own probes on
            # the linear path
            self.data.columnar.ensure_indexes()

    def _commit_delta_with_retry(self, action) -> None:
        """The store's refresh() commit entry: `fault.commit_retry()`
        retries a retryable apply failure, which is safe because
        `_apply_delta` stages before it swaps, so a failed attempt left
        nothing visible.  Other failures propagate untouched."""
        from das_tpu_torch import fault

        fault.commit_retry().run(lambda: self._apply_delta(*action))

    def get_incoming(self, handle: str) -> List[str]:
        """Incoming set: the base CSR rows plus the delta overlay (links
        committed since the last full finalize)."""
        row = self.fin.row_of_hex.get(handle)
        if row is None:
            return []
        out: List[str] = []
        if row + 1 < self.fin.incoming_offsets.shape[0]:  # base CSR rows
            lo = int(self.fin.incoming_offsets[row])
            hi = int(self.fin.incoming_offsets[row + 1])
            out = [self.fin.hex_of_row[int(r)] for r in self.fin.incoming_links[lo:hi]]
        for r in self._delta_incoming.get(row, ()):
            out.append(self.fin.hex_of_row[int(r)])
        return out
