"""`DistributedAtomSpace` — the public API facade of the PyTorch port
(port of the main-path subset of `das_tpu/api/atomspace.py`).

Backends: "memory" (the host algebra over AtomSpaceData) and "tensor"
(the store on a torch device; compilable conjunctive queries run through
the hand-written CUDA kernels, or their plain PyTorch versions on the
CPU).  `device=None` means CUDA and raises without a card; pass
`device="cpu"` for the CPU route.

`query_many` / `query_many_dispatch` are the batched serving path: the
fused-compilable queries of a batch dispatch together and pay ONE host
fetch per retry round; the answers are the strings `query()` gives.

Not ported yet: transactions and incremental commits, checkpoints and
snapshots, `explain`, the read surface (`get_node` ... `get_node_name`),
the sharded backend."""

from __future__ import annotations

import json
import logging
from enum import Enum, auto
from typing import Dict, List, Tuple, Union

from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import BreakerOpenError
from das_tpu_torch.query import compiler as query_compiler
from das_tpu_torch.query.ast import LogicalExpression, PatternMatchingAnswer
from das_tpu_torch.storage.atom_table import AtomSpaceData
from das_tpu_torch.storage.memory_db import MemoryDB
from das_tpu_torch.storage.tensor_db import TensorDB

log = logging.getLogger("das_tpu_torch")


class QueryOutputFormat(int, Enum):
    HANDLE = auto()
    ATOM_INFO = auto()
    JSON = auto()


class _QueryManyJob:
    """One batch mid-pipeline: planning and the asynchronous dispatch of
    the fused rounds happen at construction (`query_many_dispatch`);
    `settle()` pays the host fetches and materializes.  Entries the fused
    path cannot take (not compilable, missing bucket, capacity ceiling)
    resolve per query during settle: the batch degrades to the serial
    path for exactly those entries."""

    __slots__ = ("das", "queries", "output_format", "plans_lists", "idxs", "pending",
                 "db_ref", "version", "settle_rtt_ms", "cache_only")

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
        # the store (by identity) and generation the batch was planned and
        # dispatched against: a rebuild before settle re-interns row ids,
        # so settle must not materialize this batch's tables through it
        self.db_ref = das.db
        self.version = getattr(das.db, "generation", None)
        if hasattr(das.db, "dev") and queries:
            for i, q in enumerate(queries):
                plans = query_compiler.plan_query(das.db, q)
                if plans is not None:
                    self.plans_lists.append(plans)
                    self.idxs.append(i)
            if self.plans_lists:
                self.pending = query_compiler.execute_fused_many_dispatch(
                    das.db, self.plans_lists, cache_only=cache_only)

    def _stale(self) -> bool:
        """True when the dispatched rounds no longer describe the live
        store: the backend was swapped or rebuilt since dispatch."""
        db = self.das.db
        return db is not self.db_ref or getattr(db, "generation", None) != self.version

    def _stream_settled(self, pending, answer_fn):
        """Stream the fused verdicts: record the settle round-trip at the
        first yield after a fetch, re-check staleness at every yield (a
        rebuild between yields leaves the rest to the per-query loop), and
        format each entry with `answer_fn(j, table)`; a failing entry
        degrades alone to the per-query dispatcher.  Yields
        `(query index, answer)`."""
        for j, table in query_compiler.execute_fused_many_settle_iter(
                self.das.db, self.plans_lists, pending):
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
            # the store was rebuilt between dispatch and settle: drop the
            # dispatched rounds and answer everything on the live store
            self.pending = None
        if self.pending is not None:
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
        self.data = kwargs.get("data") or AtomSpaceData()
        self.data.pattern_black_list = list(self.config.pattern_black_list)
        self.db = self._make_backend(backend)
        log.info(f"New Distributed Atom Space '{self.database_name}' (backend={backend})")

    def _make_backend(self, backend: str):
        if backend == "memory":
            return MemoryDB(self.data)
        if backend == "tensor":
            return TensorDB(self.data, self.config, device=self.device)
        raise ValueError(f"Unknown backend: {backend}")

    def _refresh(self) -> None:
        if hasattr(self.db, "refresh"):
            self.db.refresh()
        else:
            self.db.prefetch()

    # -- public API --------------------------------------------------------

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

    # -- bulk loads --------------------------------------------------------

    def load_knowledge_base(self, source: str) -> None:
        """Load a `.metta` file, or every `.metta` file of a directory."""
        from das_tpu_torch.ingest.metta import load_knowledge_base

        load_knowledge_base(self.data, source)
        self._refresh()

    def load_metta_text(self, text: str) -> None:
        from das_tpu_torch.storage.atom_table import load_metta_text

        load_metta_text(text, self.data)
        self._refresh()
