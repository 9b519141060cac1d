"""`DistributedAtomSpace` — the public API facade of the PyTorch port
(port of the main-path subset of `das_tpu/api/atomspace.py`).

Backends: "memory" (the host algebra over AtomSpaceData), "tensor" (the
store on a torch device; compilable queries run through the hand-written
CUDA kernels, or their plain PyTorch versions on the CPU) and "sharded"
(the store dealt over a mesh of S = prod(config.mesh_shape) slabs,
parallel/sharded_db.py; every kernel runs shard-local).  `device=None`
means CUDA and raises without a card; pass `device="cpu"` for the CPU
route.  A sharded store with `device=None` puts one slab on each card at
hand; with a device, all slabs on it.

`query_many` / `query_many_dispatch` are the batched serving path: the
fused-compilable queries of a batch dispatch together and pay ONE host
fetch per retry round; the answers are the strings `query()` gives.
`commit_transaction` commits incrementally into the device store
(storage/delta.py); `explain` renders the planner's costed plan.

Durability (storage/checkpoint.py, storage/durable.py): with
`config.snapshot_dir` set, a tensor facade built without data restores
the newest valid snapshot generation under `<snapshot_dir>/<database_name>`
and replays its write-ahead log; built with data (or over an empty root)
it writes the first generation and logs every commit.
`save_snapshot` / `restore_snapshot` write and read generations,
`save_checkpoint` / `load_checkpoint` a flat checkpoint directory, and
`config.checkpoint_path` is loaded at construction.

Serving (das_tpu_torch/service/): the coalescer drives
`query_many_dispatch(..., cache_only=)` and `settle_iter`; planning a
batch is the `serve.plan` span of obs/, formatting an answer `exec.format`.

Bulk loads (ingest/pipeline.py): `load_knowledge_base` parses `.metta`
and `.scm` files; `load_canonical_knowledge_base` reads converter-format
files through the native C++ scanner (into the columnar store,
storage/columnar.py, when the facade is empty), which raises when it
cannot be built."""

from __future__ import annotations

import json
import logging
import os
from enum import Enum, auto
from typing import Dict, List, Optional, Tuple, Union

from das_tpu_torch import obs
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import BreakerOpenError
from das_tpu_torch.core.schema import UNORDERED_LINK_TYPES, WILDCARD
from das_tpu_torch.query import compiler as query_compiler
from das_tpu_torch.query.ast import LogicalExpression, PatternMatchingAnswer
from das_tpu_torch.query.fused import is_sharded
from das_tpu_torch.storage.atom_table import AtomSpaceData
from das_tpu_torch.storage.memory_db import MemoryDB
from das_tpu_torch.storage.tensor_db import TensorDB

log = logging.getLogger("das_tpu_torch")


class QueryOutputFormat(int, Enum):
    HANDLE = auto()
    ATOM_INFO = auto()
    JSON = auto()


class Transaction:
    """Buffer of toplevel MeTTa expression strings for an incremental
    commit."""

    def __init__(self):
        self.expressions: List[str] = []

    def add(self, expression: str) -> None:
        self.expressions.append(expression)

    # the reference's spelling of the same operation
    add_toplevel_expression = add

    def metta_string(self) -> str:
        return "\n".join(self.expressions)


class _QueryManyJob:
    """One batch mid-pipeline: planning and the asynchronous dispatch of
    the fused rounds happen at construction (`query_many_dispatch`);
    `settle()` pays the host fetches and materializes.  Entries the fused
    path cannot take (not compilable, missing bucket, capacity ceiling)
    resolve per query during settle: the batch degrades to the serial
    path for exactly those entries."""

    __slots__ = ("das", "queries", "output_format", "plans_lists", "idxs", "pending",
                 "db_ref", "version", "settle_rtt_ms", "cache_only", "sharded")

    def __init__(self, das, queries, output_format, cache_only=False):
        self.das = das
        self.queries = queries
        self.output_format = output_format
        #: degraded mode: answer from the result cache only; any other
        #: entry yields a retryable BreakerOpenError
        self.cache_only = cache_only
        self.plans_lists: List = []
        self.idxs: List[int] = []
        self.pending = None
        #: the first settle round's host fetch, ms (None: no fetch happened)
        self.settle_rtt_ms = None
        # the store (by identity) and delta_version the batch was planned
        # and dispatched against: a commit before settle may re-intern row
        # ids (a rebuild moves every link row), so settle must not
        # materialize this batch's tables through the new registries
        self.db_ref = das.db
        self.version = getattr(das.db, "delta_version", None)
        # a mesh store takes the sharded executor's dispatch/settle halves
        self.sharded = is_sharded(das.db)
        if (self.sharded or isinstance(das.db, TensorDB)) and queries:
            with obs.span("serve.plan", queries=len(queries)) as sp:
                for i, q in enumerate(queries):
                    plans = query_compiler.plan_query(das.db, q)
                    if plans is not None:
                        self.plans_lists.append(plans)
                        self.idxs.append(i)
                sp.set(compilable=len(self.plans_lists))
            if self.plans_lists:
                dispatch = (query_compiler.execute_sharded_many_dispatch if self.sharded
                            else query_compiler.execute_fused_many_dispatch)
                self.pending = dispatch(das.db, self.plans_lists, cache_only=cache_only)

    def _stale(self) -> bool:
        """True when the dispatched rounds no longer describe the live
        store: the backend was swapped, or a commit bumped delta_version
        past the one captured at dispatch."""
        db = self.das.db
        return db is not self.db_ref or getattr(db, "delta_version", None) != self.version

    def _stream_settled(self, pending, answer_fn):
        """Stream the fused verdicts: record the settle round-trip at the
        first yield after a fetch, re-check staleness at every yield (a
        commit between yields leaves the rest to the per-query loop), and
        format each entry with `answer_fn(j, table)`; a failing entry
        degrades alone to the per-query dispatcher.  Yields
        `(query index, answer)`."""
        settle_iter = (query_compiler.execute_sharded_many_settle_iter if self.sharded
                       else query_compiler.execute_fused_many_settle_iter)
        for j, table in settle_iter(self.das.db, self.plans_lists, pending):
            if self.settle_rtt_ms is None and pending.fetch_ms:
                self.settle_rtt_ms = pending.fetch_ms[0]
            if self._stale():
                break
            try:
                out_s = answer_fn(j, table)
            except Exception:  # noqa: BLE001 — the per-query loop re-runs it
                continue
            yield self.idxs[j], out_s

    def settle_iter(self):
        """Yields `(query index, answer string or Exception)` as each
        answer becomes final: fused answers in verdict order (a settle-time
        decline replays on the staged path in its slot), then dispatch-time
        declines and non-compilable queries through `query()`.  Every
        index is yielded exactly once; a failed entry yields its OWN
        exception, never a batch-mate's."""
        das = self.das
        done = [False] * len(self.queries)
        if self.pending is not None and self._stale():
            # a commit landed between dispatch and settle: drop the
            # dispatched rounds and answer everything on the live store
            self.pending = None
        if self.pending is not None and self.sharded:
            pending, self.pending = self.pending, None
            from das_tpu_torch.parallel.sharded_db import ShardedTable

            def sharded_answer(j, res):
                if res is None:
                    if self.cache_only:
                        raise BreakerOpenError()
                    # the fused mesh job declined (ceiling, reseed): the
                    # staged mesh pipeline answers, with the same answers
                    table = das.db.sharded_execute(self.plans_lists[j])
                else:
                    table = ShardedTable(res.var_names, res.vals, res.valid, res.count,
                                         host_vals=res.host_vals, host_valid=res.host_valid)
                answer = PatternMatchingAnswer()
                matched = das.db.materialize(table, answer)
                out_s = das._format_answer(matched, answer, self.output_format)
                query_compiler.ROUTE_COUNTS["sharded"] += 1
                # only the fused answers ran the kernels' whole program
                if res is not None and das.db.device.type == "cuda":
                    query_compiler.ROUTE_COUNTS["sharded_kernel"] += 1
                return out_s

            for i, out_s in self._stream_settled(pending, sharded_answer):
                done[i] = True
                yield i, out_s
        elif self.pending is not None:
            pending, self.pending = self.pending, None

            def fused_answer(j, table):
                route = "fused"
                if table is None:
                    if self.cache_only:
                        raise BreakerOpenError()
                    # the fused path declined (ceiling, a result still
                    # flagged): the answer-identical staged path answers
                    table = query_compiler.execute_plan(das.db, self.plans_lists[j])
                    route = "staged"
                answer = PatternMatchingAnswer()
                matched = query_compiler.materialize(das.db, table, answer)
                out_s = das._format_answer(matched, answer, self.output_format)
                # counted once the answer exists: a failure re-runs through
                # query(), which counts its own route
                query_compiler.ROUTE_COUNTS[route] += 1
                return out_s

            for i, out_s in self._stream_settled(pending, fused_answer):
                done[i] = True
                yield i, out_s
        for i, q in enumerate(self.queries):
            if done[i]:
                continue
            if self.cache_only:
                yield i, BreakerOpenError()
                continue
            try:
                yield i, das.query(q, self.output_format)
            except Exception as exc:  # noqa: BLE001 — per-query isolation
                yield i, exc

    def settle(self) -> List[Union[str, Exception]]:
        """One entry per query: the answer string, or that query's own
        exception (the list form of settle_iter)."""
        out: List[Union[str, Exception]] = [None] * len(self.queries)
        for i, answer in self.settle_iter():
            out[i] = answer
        return out


class DistributedAtomSpace:
    def __init__(self, **kwargs):
        self.database_name = kwargs.get("database_name", "das")
        self.config: DasConfig = kwargs.get("config") or DasConfig()
        backend = kwargs.get("backend", self.config.backend)
        self.config.backend = backend
        self.device = kwargs.get("device")
        data = kwargs.get("data")
        if data is None and self.config.snapshot_dir and backend in ("tensor", "sharded"):
            # a populated snapshot root: the newest valid generation, its
            # WAL replayed, and the warm bundle; commits keep logging
            from das_tpu_torch.storage import durable

            root = self._snapshot_root()
            if durable.list_generations(root):
                self.db = durable.restore(root, config=self.config, backend=backend,
                                          device=self.device)
                self.data = self.db.data
                self.pattern_black_list = list(self.config.pattern_black_list)
                log.info(f"New Distributed Atom Space '{self.database_name}' "
                         f"(backend={backend}, restored from {root})")
                return
        if data is None and self.config.checkpoint_path:
            from das_tpu_torch.storage import checkpoint

            if os.path.isdir(self.config.checkpoint_path):
                data = checkpoint.load(self.config.checkpoint_path)
            else:
                log.warning(f"checkpoint_path '{self.config.checkpoint_path}' does not "
                            "exist; starting with an empty AtomSpace")
        self.data = data or AtomSpaceData()
        self.pattern_black_list = list(self.config.pattern_black_list)
        self.db = self._make_backend(backend)
        if self.config.snapshot_dir and backend in ("tensor", "sharded"):
            # a fresh store under a snapshot root: the first generation
            # (the WAL needs a base to replay onto), then the delta log
            from das_tpu_torch.storage import durable

            durable.attach(self.db, self._snapshot_root())
        log.info(f"New Distributed Atom Space '{self.database_name}' (backend={backend})")

    def _snapshot_root(self) -> Optional[str]:
        """This facade's snapshot root: `snapshot_dir` namespaced by
        database_name, so one generation lineage holds one store's history
        (two stores sharing a root would interleave their versions in one
        WAL).  `TensorDB.restore(path)` takes a lineage directory itself."""
        if not self.config.snapshot_dir:
            return None
        return os.path.join(self.config.snapshot_dir, self.database_name)

    def _make_backend(self, backend: str):
        if backend == "memory":
            return MemoryDB(self.data)
        if backend == "tensor":
            return TensorDB(self.data, self.config, device=self.device)
        if backend == "sharded":
            from das_tpu_torch.parallel.sharded_db import ShardedDB

            return ShardedDB(self.data, self.config, device=self.device)
        raise ValueError(f"Unknown backend: {backend}")

    def _refresh(self) -> None:
        if hasattr(self.db, "refresh"):
            self.db.refresh()
        else:
            self.db.prefetch()

    @property
    def pattern_black_list(self) -> List[str]:
        """Lives on the AtomSpaceData, so every backend reads the same
        list; assignment writes through."""
        return self.data.pattern_black_list

    @pattern_black_list.setter
    def pattern_black_list(self, value: List[str]) -> None:
        self.data.pattern_black_list = list(value)

    # -- public API --------------------------------------------------------

    def clear_database(self) -> None:
        """An empty store on a new backend of the same kind and device,
        keeping the black list; under a snapshot root it is written as a
        new generation."""
        black_list = self.pattern_black_list
        self.data = AtomSpaceData()
        self.data.pattern_black_list = black_list
        self.db = self._make_backend(self.config.backend)
        if self.config.snapshot_dir and self.config.backend in ("tensor", "sharded"):
            # a durable store's clear is a state change: the empty store is
            # a new generation (the old WAL's versions would not continue)
            from das_tpu_torch.storage import durable

            durable.write_snapshot(self.db, self._snapshot_root())

    def count_atoms(self) -> Tuple[int, int]:
        return self.db.count_atoms()

    def get_atom(self, handle: str,
                 output_format: QueryOutputFormat = QueryOutputFormat.HANDLE
                 ) -> Union[str, Dict]:
        if output_format == QueryOutputFormat.HANDLE or not handle:
            atom = self.db.get_atom_as_dict(handle)
            return atom["handle"] if atom else ""
        if output_format == QueryOutputFormat.ATOM_INFO:
            return self.db.get_atom_as_dict(handle)
        if output_format == QueryOutputFormat.JSON:
            answer = self.db.get_atom_as_deep_representation(handle)
            return json.dumps(answer, sort_keys=False, indent=4)
        raise ValueError(f"Invalid output format: '{output_format}'")

    def get_node(self, node_type: str, node_name: str,
                 output_format: QueryOutputFormat = QueryOutputFormat.HANDLE
                 ) -> Union[str, Dict, None]:
        node_handle = self.db.get_node_handle(node_type, node_name)
        if not self.db.node_exists(node_type, node_name):
            log.warning(f"Attempt to access an invalid Node '{node_type}:{node_name}'")
            return None
        if output_format == QueryOutputFormat.HANDLE:
            return node_handle
        if output_format == QueryOutputFormat.ATOM_INFO:
            return self.db.get_atom_as_dict(node_handle)
        if output_format == QueryOutputFormat.JSON:
            answer = self.db.get_atom_as_deep_representation(node_handle)
            return json.dumps(answer, sort_keys=False, indent=4)
        raise ValueError(f"Invalid output format: '{output_format}'")

    def get_nodes(self, node_type: str, node_name: Optional[str] = None,
                  output_format: QueryOutputFormat = QueryOutputFormat.HANDLE
                  ) -> Union[List[str], List[Dict], str]:
        if node_name is not None:
            handle = self.db.get_node_handle(node_type, node_name)
            answer = [handle] if self.db.node_exists(node_type, node_name) else []
        else:
            answer = self.db.get_all_nodes(node_type)
        if output_format == QueryOutputFormat.HANDLE or not answer:
            return answer
        if output_format == QueryOutputFormat.ATOM_INFO:
            return [self.db.get_atom_as_dict(h) for h in answer]
        if output_format == QueryOutputFormat.JSON:
            deep = [self.db.get_atom_as_deep_representation(h) for h in answer]
            return json.dumps(deep, sort_keys=False, indent=4)
        raise ValueError(f"Invalid output format: '{output_format}'")

    def get_link(self, link_type: str, targets: Optional[List[str]] = None,
                 output_format: QueryOutputFormat = QueryOutputFormat.HANDLE
                 ) -> Union[str, Dict, None]:
        link_handle = self.db.get_link_handle(link_type, targets or [])
        if not self.db.link_exists(link_type, targets or []):
            return None
        if output_format == QueryOutputFormat.HANDLE:
            return link_handle
        if output_format == QueryOutputFormat.ATOM_INFO:
            return self.db.get_atom_as_dict(link_handle, len(targets or []))
        if output_format == QueryOutputFormat.JSON:
            answer = self.db.get_atom_as_deep_representation(link_handle, len(targets or []))
            return json.dumps(answer, sort_keys=False, indent=4)
        raise ValueError(f"Invalid output format: '{output_format}'")

    def _to_handle_list(self, db_answer) -> List[str]:
        if not db_answer:
            return []
        return [atom if isinstance(atom, str) else atom[0] for atom in db_answer]

    @staticmethod
    def _handle_arity(atom):
        if isinstance(atom, str):
            return atom, -1
        handle, targets = atom
        return handle, len(targets)

    def _to_link_dict_list(self, db_answer) -> List[Dict]:
        return [self.db.get_atom_as_dict(*self._handle_arity(atom)) for atom in db_answer or []]

    def _to_json(self, db_answer) -> str:
        answer = [self.db.get_atom_as_deep_representation(*self._handle_arity(atom))
                  for atom in db_answer or []]
        return json.dumps(answer, sort_keys=False, indent=4)

    def get_links(self, link_type: str, target_types: Optional[List[str]] = None,
                  targets: Optional[List[str]] = None,
                  output_format: QueryOutputFormat = QueryOutputFormat.HANDLE
                  ) -> Union[List[str], List[Dict], str]:
        if link_type is None:
            link_type = WILDCARD
        if target_types is not None and link_type != WILDCARD:
            db_answer = self.db.get_matched_type_template([link_type, *target_types])
        elif targets is not None:
            if link_type in UNORDERED_LINK_TYPES and WILDCARD in targets:
                # the reference's production semantics for an unordered
                # wildcard probe: the probe key hashes the SORTED handles,
                # so it matches positionally against the sorted probe; the
                # store's multiset probe is a superset, filtered down here
                probe = sorted(targets)
                db_answer = [
                    m for m in self.db.get_matched_links(link_type, probe)
                    if all(p == WILDCARD or p == t for p, t in zip(probe, m[1]))
                ]
            else:
                db_answer = self.db.get_matched_links(link_type, targets)
        elif link_type != WILDCARD:
            db_answer = self.db.get_matched_type(link_type)
        else:
            raise ValueError("Invalid parameters")
        if output_format == QueryOutputFormat.HANDLE:
            return self._to_handle_list(db_answer)
        if output_format == QueryOutputFormat.ATOM_INFO:
            return self._to_link_dict_list(db_answer)
        if output_format == QueryOutputFormat.JSON:
            return self._to_json(db_answer)
        raise ValueError(f"Invalid output format: '{output_format}'")

    def get_link_type(self, link_handle: str) -> str:
        return self.db.get_link_type(link_handle)

    def get_link_targets(self, link_handle: str) -> List[str]:
        return self.db.get_link_targets(link_handle)

    def get_node_type(self, node_handle: str) -> str:
        return self.db.get_node_type(node_handle)

    def get_node_name(self, node_handle: str) -> str:
        return self.db.get_node_name(node_handle)

    # -- query -------------------------------------------------------------

    def _render_assignment(self, assignment, deep: bool):
        get = self.db.get_atom_as_deep_representation if deep else self.db.get_atom_as_dict
        if hasattr(assignment, "mapping"):
            return {var: get(h) for var, h in assignment.mapping.items()}
        return repr(assignment)

    def _dispatch_query(self, query: LogicalExpression, answer: PatternMatchingAnswer):
        """The device path for compilable queries, the host algebra
        otherwise (query_compiler.dispatch)."""
        return query_compiler.dispatch(self.db, query, answer)

    def query_answer(self, query: LogicalExpression) -> Tuple[bool, PatternMatchingAnswer]:
        """Structured query result (assignment objects, not strings)."""
        answer = PatternMatchingAnswer()
        matched = self._dispatch_query(query, answer)
        return bool(matched), answer

    def query(self, query: LogicalExpression,
              output_format: QueryOutputFormat = QueryOutputFormat.HANDLE) -> str:
        answer = PatternMatchingAnswer()
        matched = self._dispatch_query(query, answer)
        return self._format_answer(matched, answer, output_format)

    def query_many(self, queries: List[LogicalExpression],
                   output_format: QueryOutputFormat = QueryOutputFormat.HANDLE) -> List[str]:
        """Batched `query`: the fused-compilable queries of a device store
        dispatch together and pay ONE host fetch per retry round; the rest
        go through the per-query dispatcher.  The strings equal query()'s;
        an entry's exception is raised."""
        if len(queries) <= 1:
            return [self.query(q, output_format) for q in queries]
        answers = self.query_many_dispatch(queries, output_format).settle()
        for a in answers:
            if isinstance(a, Exception):
                raise a
        return answers

    def query_many_dispatch(self, queries: List[LogicalExpression],
                            output_format: QueryOutputFormat = QueryOutputFormat.HANDLE,
                            cache_only: bool = False) -> _QueryManyJob:
        """The dispatch half of query_many: plan the batch and enqueue its
        fused rounds without waiting for the card.  The job's `settle()`
        returns one entry per query, the answer string or that query's own
        exception.  With cache_only only result-cache hits answer; every
        other entry is a retryable BreakerOpenError."""
        return _QueryManyJob(self, queries, output_format, cache_only=cache_only)

    def _format_answer(self, matched, answer: PatternMatchingAnswer, output_format) -> str:
        """The answer string of every query path; the `exec.format` span
        when tracing is on."""
        sp = obs.NOOP_SPAN
        if obs.enabled():
            sp = obs.span("exec.format", answers=len(answer.assignments) if matched else 0,
                          format=getattr(output_format, "name", str(output_format)))
        with sp:
            tag_not = ""
            mapping = ""
            if matched:
                if answer.negation:
                    tag_not = "NOT "
                if output_format == QueryOutputFormat.HANDLE:
                    mapping = str(answer.assignments)
                elif output_format == QueryOutputFormat.ATOM_INFO:
                    mapping = str([self._render_assignment(a, deep=False)
                                   for a in answer.assignments])
                elif output_format == QueryOutputFormat.JSON:
                    mapping = json.dumps(
                        [self._render_assignment(a, deep=True) for a in answer.assignments],
                        sort_keys=False, indent=4,
                    )
                else:
                    raise ValueError(f"Invalid output format: '{output_format}'")
            return f"{tag_not}{mapping}"

    def explain(self, query: LogicalExpression, execute: bool = False,
                compile: bool = False) -> Dict:
        """The planner's costed plan for `query` (planner.explain): order,
        route, estimated rows and capacity seeds; with execute=True the
        actual per-stage rows and retry rounds beside them."""
        return query_compiler.explain(self.db, query, execute=execute, compile=compile)

    # -- transactions ------------------------------------------------------

    def open_transaction(self) -> Transaction:
        return Transaction()

    def commit_transaction(self, transaction: Transaction) -> None:
        """Parse the transaction into the host store, then commit it to the
        device store (incrementally where storage/delta.py allows)."""
        from das_tpu_torch.storage.atom_table import load_metta_text

        load_metta_text(transaction.metta_string(), self.data)
        self._refresh()

    # -- bulk loads --------------------------------------------------------

    def load_knowledge_base(self, source: str) -> None:
        """Load a `.metta` or `.scm` file, or every such file of a
        directory."""
        from das_tpu_torch.ingest.pipeline import load_knowledge_base

        load_knowledge_base(self.data, source)
        self._refresh()
        log.info("Loaded KB: %d nodes, %d links", *self.count_atoms())

    def load_canonical_knowledge_base(self, source: str) -> None:
        """Load canonical (converter-format) `.metta` file(s) through the
        native scanner; it raises when the scanner cannot be built."""
        from das_tpu_torch.ingest.pipeline import load_canonical_knowledge_base

        load_canonical_knowledge_base(self.data, source)
        self._refresh()
        log.info("Loaded canonical KB: %d nodes, %d links", *self.count_atoms())

    def load_metta_text(self, text: str) -> None:
        from das_tpu_torch.storage.atom_table import load_metta_text

        load_metta_text(text, self.data)
        self._refresh()

    # -- checkpoints and snapshots -----------------------------------------

    def save_checkpoint(self, path: str, with_indexes: bool = True) -> None:
        """Write the AtomSpace (records and, by default, the probe indexes)
        to a checkpoint directory; a sharded store also saves its slabs, so
        a restart uploads them directly (no re-partition)."""
        from das_tpu_torch.storage import checkpoint

        if with_indexes and is_sharded(self.db):
            checkpoint.save_sharded(self.db, path)
        else:
            checkpoint.save(self.data, path, with_indexes=with_indexes)

    def load_checkpoint(self, path: str) -> None:
        """Replace the contents with a checkpoint (a flat directory, or a
        snapshot root with its WAL commits), on the facade's device."""
        from das_tpu_torch.storage import checkpoint

        self.data = checkpoint.load(path)
        self.db = self._make_backend(self.config.backend)

    def save_snapshot(self, path: Optional[str] = None) -> str:
        """One atomic generational snapshot of the live store under `path`
        (default: the facade's snapshot root); the WAL moves to the new
        generation.  Returns the generation directory."""
        from das_tpu_torch.storage import durable

        root = path or self._snapshot_root()
        if not root:
            raise ValueError("no snapshot root: pass a path or set DasConfig.snapshot_dir")
        return durable.write_snapshot(self.db, root)

    def restore_snapshot(self, path: Optional[str] = None) -> None:
        """Replace the contents with the newest valid generation under
        `path` (default: the facade's snapshot root), its WAL replayed and
        its warm bundle applied, on the facade's device."""
        from das_tpu_torch.storage import durable

        root = path or self._snapshot_root()
        if not root:
            raise ValueError("no snapshot root: pass a path or set DasConfig.snapshot_dir")
        self.db = durable.restore(root, config=self.config, backend=self.config.backend,
                                  device=self.device)
        self.data = self.db.data
