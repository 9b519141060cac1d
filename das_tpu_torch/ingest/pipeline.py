"""Multi-file load pipeline (port of `das_tpu/ingest/pipeline.py`).

The reference load path is a 10-thread relay (parse threads with 10s
staggered starts to dodge PLY's unsafe startup, four index-building threads
shelling out to sort(1), Mongo/Redis uploader threads synchronized by
ok-counters — parser_threads.py:78-335, distributed_atom_space.py:138-168).

Here parsing is re-entrant and indexes are derived tensors, so the
pipeline collapses to: parse files concurrently (thread pool — useful when
the native C++ scanner releases the GIL; harmless otherwise), merge
records into the store per file, then finalize + upload once.  Failure
semantics are deterministic: any parse error aborts the whole load before
the store is touched (the reference swallows duplicate errors mid-upload,
leaving partial state).

`.metta` files go through the MeTTa parser and `.scm` files through the
Atomese parser (ingest/atomese.py); both land in the same store.  The
canonical fast path (`load_canonical_knowledge_base`) always runs the native
C++ scanner and raises when it cannot be built; the Python reader of the
same format is `ingest/canonical.py` (`load_canonical_file`), whose result
a caller may hand to the facade as `DistributedAtomSpace(data=...)`."""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from threading import Lock
from typing import List, Optional

from das_tpu_torch.core.expression import Expression
from das_tpu_torch.ingest.metta import MettaParser
from das_tpu_torch.storage.atom_table import AtomSpaceData

log = logging.getLogger("das_tpu_torch")


def knowledge_base_file_list(source: str) -> List[str]:
    """File-or-directory expansion to the `.metta` and `.scm` files of a
    knowledge base (reference distributed_atom_space.py:81-99)."""
    answer = []
    if os.path.isfile(source):
        answer.append(source)
    elif os.path.isdir(source):
        for file_name in sorted(os.listdir(source)):
            path = os.path.join(source, file_name)
            if os.path.exists(path):
                answer.append(path)
    else:
        raise ValueError(f"Invalid knowledge base path: {source}")
    answer = [f for f in answer if f.endswith(".metta") or f.endswith(".scm")]
    if not answer:
        raise ValueError(f"No MeTTa files found in {source}")
    return answer


class _FileResult:
    def __init__(self):
        self.typedefs: List[Expression] = []
        self.terminals: List[Expression] = []
        self.regular: List[Expression] = []


def _parse_one(data: AtomSpaceData, path: str, lock: Lock) -> _FileResult:
    result = _FileResult()
    with open(path, "r") as fh:
        text = fh.read()
    if path.endswith(".scm"):
        from das_tpu_torch.ingest.atomese import AtomeseParser

        parser_cls = AtomeseParser
    else:
        parser_cls = MettaParser
    parser = parser_cls(
        symbol_table=data.table,
        on_typedef=result.typedefs.append,
        on_terminal=result.terminals.append,
        on_expression=result.regular.append,
        on_toplevel=result.regular.append,
    )
    # symbol table writes are dict inserts of deterministic values; shared
    # table + lock keeps cross-file type knowledge consistent
    with lock:
        parser.parse(text)
    return result


def load_knowledge_base(
    data: AtomSpaceData, source: str, max_workers: Optional[int] = None
) -> AtomSpaceData:
    """Parse .metta/.scm file(s) into the store (general parser path)."""
    files = knowledge_base_file_list(source)
    log.info("Loading knowledge base: %d file(s)", len(files))
    lock = Lock()
    if len(files) == 1:
        results = [_parse_one(data, files[0], lock)]
    else:
        with ThreadPoolExecutor(max_workers=max_workers or min(8, len(files))) as ex:
            results = list(ex.map(lambda p: _parse_one(data, p, lock), files))
    for result in results:
        for expr in result.typedefs:
            data.add_typedef(expr)
        for expr in result.terminals:
            data.add_terminal(expr)
        for expr in result.regular:
            data.add_link(expr)
    log.info("Finished loading knowledge base")
    return data


def load_canonical_knowledge_base(data: AtomSpaceData, source: str) -> AtomSpaceData:
    """Canonical fast path (one toplevel expression per line; see
    ingest/canonical.py).  Files are processed in reverse-sorted order like
    the reference (distributed_atom_space.py:405).

    Runs the native C++ scanner (ingest/native.py), which raises
    `NativeBuildError` when it cannot be built: on an empty store the
    chunk-parallel columnar scan and the lazy-view store
    (storage/columnar.py), otherwise the record stream into the existing
    dicts."""
    from das_tpu_torch.ingest import native

    files = sorted(knowledge_base_file_list(source), reverse=True)
    if not (data.nodes or data.links or data.typedefs):
        log.info("Canonical KB (columnar scanner): %d file(s)", len(files))
        return native.load_canonical_files_columnar(files, data)
    log.info("Canonical KB (native scanner): %d file(s)", len(files))
    return native.load_canonical_files_native(files, data)
