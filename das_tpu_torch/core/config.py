"""Configuration of the PyTorch port.

A trimmed copy of `das_tpu.core.config.DasConfig`: only the fields this
port reads, with the JAX package's defaults.  There is no kernel routing
knob — a CUDA tensor goes to the hand-written kernel and a CPU tensor to
its plain PyTorch version.  The two planner switches are read from the
config only (no environment variable):

  * `use_planner` — the cost-based planner (das_tpu_torch/planner/) picks
    the join order and the capacity seeds of every step; "auto"/"on" = on,
    "off" = the greedy order with the blind seeds;
  * `use_multiway` — the planner may fuse a star prefix into one k-way
    multiway step (kernels/multiway.py): "auto" = when the byte model says
    it beats the binary chain (>= 3 clauses), "on" = every eligible prefix
    (>= 2 clauses), "off" = the binary chain only.  Routed by the planner,
    so `use_planner="off"` turns it off too.

`use_tree_fusion` ("auto"/"on"/"off") routes an eligible Or tree to one
whole-tree job; it too is read from the config only.
The sharded backend (parallel/sharded_db.py) has S = prod(`mesh_shape`)
slabs.  `das_tpu`'s `mesh_axis_names` (defined, never read) and
`sharded_tree_fallback` (the port always runs trees on the mesh) have no
counterpart.
Canonical loads (ingest/pipeline.py) always run the native C++ scanner,
which raises when it cannot be built: `das_tpu`'s `use_native_ingest`, its
environment switches `DAS_TPU_NO_NATIVE`, `DAS_TPU_COLUMNAR`,
`DAS_TPU_NATIVE_LIB` and its unread `ingest_chunk_size` have no
counterpart.
`result_cache_size` bounds the fused executor's answered-result cache (0
disables it); `delta_merge_threshold` bounds the atoms incremental
commits may add before the store is fully re-finalized.

Durability (storage/checkpoint.py, storage/durable.py): `checkpoint_path`
is a checkpoint the facade loads at construction; `snapshot_dir` is the
root of the generational snapshots (namespaced by the facade's
`database_name`), restored at construction when it holds a generation
and written otherwise, with the write-ahead delta log always armed under
it; `snapshot_keep` bounds
the generations that survive pruning; `cap_store_dir` is the directory of
the learned-capacity files (query/fused.py `CapStore`), None = kept in
memory only.  None of them is read from the environment.

Serving (service/coalesce.py, service/server.py), with `das_tpu`'s
defaults: `coalesce_max_batch`, `pipeline_depth`, `pipeline_depth_max`,
`coalesce_queue_max`, `query_deadline_ms`, `breaker_failure_threshold`,
`breaker_cooldown_ms`.  The switches `das_tpu` reads from its environment
are not fields: the fault plan and the trace recorder are process-wide
and set only by `fault.configure(spec)` (DAS_TPU_FAULT),
`obs.configure(enabled=, capacity=, annotations=)` (DAS_TPU_TRACE,
DAS_TPU_TRACE_RING, DAS_TPU_TRACE_JAX) and `proflog.configure(enabled=)`
(DAS_TPU_PROFLOG);
the metrics port is `transport.serve(metrics_port=)`
(DAS_TPU_METRICS_PORT); query RPCs are always coalesced
(DAS_TPU_COALESCE).  `profiler_trace_dir` (DAS_TPU_TRACE_DIR) is where a
service writes its torch.profiler trace (obs/torchprof.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class DasConfig:
    backend: str = "tensor"          # "memory" | "tensor" | "sharded"
    # the sharded backend's shard count is prod(mesh_shape); None = one
    # shard per CUDA card at hand (parallel/mesh.py make_mesh)
    mesh_shape: Optional[Tuple[int, ...]] = None
    # capacity (rows) for padded device result buffers; doubled on overflow
    initial_result_capacity: int = 1 << 14
    max_result_capacity: int = 1 << 24
    # incremental commits: total delta atoms held as an LSM overlay before
    # the store is fully re-finalized (storage/tensor_db.py refresh)
    delta_merge_threshold: int = 1 << 16
    pattern_black_list: List[str] = field(default_factory=list)
    use_planner: str = "auto"
    use_multiway: str = "auto"
    # answered-result cache of the fused executor (query/fused.py
    # ResultCache): at most this many results per executor, keyed by plan
    # shape and grounded values and valid for one `delta_version`; the
    # batched serving path and count_batch consult it.  0 disables it.
    result_cache_size: int = 256
    # whole-tree fusion (query/tree.py tree_fusion_enabled): an Or/negation
    # tree whose every branch is an ordered conjunction over one variable
    # universe runs as ONE tree job with one host fetch a round.  "auto" =
    # on (ineligible shapes take the staged tree, same answers); "off" =
    # the staged tree always.
    use_tree_fusion: str = "auto"
    # durability: a checkpoint directory loaded at construction
    checkpoint_path: Optional[str] = None
    # generational snapshot root (storage/durable.py); the facade
    # namespaces it by database_name
    snapshot_dir: Optional[str] = None
    # completed generations kept by pruning
    snapshot_keep: int = 2
    # directory of the learned-capacity files (query/fused.py CapStore);
    # None keeps them in memory only
    cap_store_dir: Optional[str] = None

    # -- serving edge (service/coalesce.py) --------------------------------
    # widest batch one coalescer drain may form
    coalesce_max_batch: int = 256
    # floor of the in-flight dispatch window (1 = serial batches)
    pipeline_depth: int = 2
    # ceiling of the adaptive window ceil(settle_rtt / dispatch_cost)
    pipeline_depth_max: int = 8
    # submit-queue bound: past it submit() rejects with
    # CoalescerSaturatedError (0 = unbounded)
    coalesce_queue_max: int = 8192
    # per-query serving deadline in ms (0 = off)
    query_deadline_ms: int = 0
    # consecutive retryable settle failures (or saturation rejections)
    # that trip a tenant's circuit breaker (0 = no breaker)
    breaker_failure_threshold: int = 8
    # how long an open breaker waits before one half-open probe
    breaker_cooldown_ms: int = 250

    # -- observability -----------------------------------------------------
    # directory of the torch.profiler Chrome traces that
    # obs/torchprof.py maybe_start_trace / maybe_stop_trace write (the
    # service starts one with its config); None = no profiler trace
    profiler_trace_dir: Optional[str] = None
