"""`DistributedAtomSpace` — the public API facade of the PyTorch port
(port of the main-path subset of `das_tpu/api/atomspace.py`).

Backends: "memory" (the host algebra over AtomSpaceData) and "tensor"
(the store on a torch device; compilable conjunctive queries run through
the hand-written CUDA kernels, or their plain PyTorch versions on the
CPU).  `device=None` means CUDA and raises without a card; pass
`device="cpu"` for the CPU route.

Not ported yet: transactions and incremental commits, checkpoints and
snapshots, batched `query_many`, `explain`, the sharded backend."""

from __future__ import annotations

import json
import logging
from enum import Enum, auto
from typing import Dict, Tuple, Union

from das_tpu_torch.core.config import DasConfig
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

    def query_answer(self, query: LogicalExpression) -> Tuple[bool, PatternMatchingAnswer]:
        """Structured query result (assignment objects, not strings)."""
        answer = PatternMatchingAnswer()
        matched = query_compiler.dispatch(self.db, query, answer)
        return bool(matched), answer

    def query(self, query: LogicalExpression,
              output_format: QueryOutputFormat = QueryOutputFormat.HANDLE) -> str:
        matched, answer = self.query_answer(query)
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
