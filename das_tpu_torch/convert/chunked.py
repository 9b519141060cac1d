"""Multi-process paren-balanced parse fan-out (SURVEY.md §2.10 P3).

Role of reference das/atomese2metta/parser.py:47-130
(MultiprocessingParser): split an s-expression source at paren-balance-zero
boundaries into chunks of whole toplevel expressions — quoted strings are
blanked first so parentheses inside names don't skew the count — and parse
the chunks in a process pool.

Redesign notes (not a port): the reference pickles pyparsing trees through
temp files and reassembles them in waves of `multiprocessing.Process`; here
chunks go through a `multiprocessing.Pool` and each worker returns plain
nested-list s-expression trees (pickle-friendly), concatenated in input
order.  Hash computation happens AFTER the merge in the single-threaded
translator — parallelizing the *tokenize+tree* stage is where the
reference measured its win, and it keeps the symbol tables single-writer."""

from __future__ import annotations

import multiprocessing
from io import StringIO
from typing import Iterable, Iterator, List, Union

def _line_delta(line: str, in_string: bool) -> tuple:
    """Net parenthesis balance of one line and the carried-over in-string
    state.  ``;`` comments (outside strings) run to end of line; quoted
    strings may span lines (Scheme allows embedded newlines)."""
    delta = 0
    for ch in line:
        if in_string:
            if ch == '"':
                in_string = False
            continue
        if ch == '"':
            in_string = True
        elif ch == ";":
            break
        elif ch == "(":
            delta += 1
        elif ch == ")":
            delta -= 1
    return delta, in_string


def paren_delta(line: str) -> int:
    """Net parenthesis balance of one self-contained line (strings closed
    within the line), ignoring quoted strings and ``;`` comments."""
    return _line_delta(line, False)[0]


def split_balanced(
    source: Union[str, Iterable[str]], chunk_exprs: int = 1000
) -> Iterator[str]:
    """Yield chunks of whole toplevel expressions: a chunk boundary can
    only fall where the running paren balance returns to zero OUTSIDE any
    quoted string."""
    if isinstance(source, str):
        source = StringIO(source)
    balance = 0
    in_string = False
    exprs_done = 0
    buf: List[str] = []
    for line in source:
        stripped = line.rstrip("\n")
        if not stripped and balance == 0 and not in_string:
            continue
        delta, in_string = _line_delta(stripped, in_string)
        balance += delta
        if balance < 0:
            raise ValueError("unbalanced parentheses (negative balance)")
        buf.append(stripped)
        if balance == 0 and not in_string:
            exprs_done += 1
            if exprs_done >= chunk_exprs:
                yield "\n".join(buf)
                buf = []
                exprs_done = 0
    if balance != 0 or in_string:
        raise ValueError("unbalanced parentheses at end of input")
    if buf:
        yield "\n".join(buf)


def parse_sexpr_trees(chunk: str) -> List[list]:
    """One chunk -> list of nested-list trees.  Delegates to the serial
    atomese parser (single source of truth for comment/string handling),
    so multiprocess and serial paths cannot diverge."""
    from das_tpu_torch.convert.atomese2metta import parse_sexpr

    return parse_sexpr(chunk)


def parse_multiprocess(
    source: Union[str, Iterable[str]],
    processes: int | None = None,
    chunk_exprs: int = 1000,
) -> List[list]:
    """Parse a whole source with a process pool; trees come back in input
    order.  Single-chunk inputs skip the pool entirely."""
    chunks = list(split_balanced(source, chunk_exprs))
    if len(chunks) <= 1:
        return parse_sexpr_trees(chunks[0]) if chunks else []
    processes = processes or multiprocessing.cpu_count()
    # forkserver: plain fork() of a threaded process is deprecated on 3.12
    # and deadlock-prone.  The preload makes the forkserver parent import
    # this module ONCE so workers fork with it loaded.  Its import chain
    # (the das_tpu_torch package, convert/, core/exceptions.py) is
    # standard library only: no torch, so no CUDA context and no device
    # threads in the parent a forked child could deadlock on.
    try:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(["das_tpu_torch.convert.chunked"])
    except ValueError:  # platform without forkserver
        ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(processes, len(chunks))) as pool:
        parsed = pool.map(parse_sexpr_trees, chunks)
    return [tree for trees in parsed for tree in trees]
