"""DL001 — no host synchronization on a dispatch path.

Contract (query/fused.py `_ExecJob`, service/coalesce.py): the serving
pipeline's throughput comes from dispatch being PURELY asynchronous —
the coalescer keeps pipeline_depth batches in flight because
dispatch_many only enqueues kernels and the non-blocking host copies
behind them (`stage_many`).  One stray `.item()` / `.cpu()` /
`torch.cuda.synchronize()` (or an int()/float()/bool() coercion, which
torch resolves by blocking on the card) inside a dispatch half silently
serializes the whole window: every batch waits for the card at dispatch
time and the depth-N pipeline degrades to serial without failing a
single functional test.  Waiting belongs in settle — `settle_pending_iter`
pays exactly one `retried_fetch` per retry round, which FETCH_COUNTS
pins.

Scope (mechanical): function bodies, nested defs included, of
  * functions named `dispatch_many`, `dispatch_pending`, or matching
    `*_dispatch` (execute_fused_many_dispatch, query_many_dispatch,
    starcount's `_dispatch`, ...);
  * methods named `dispatch` on classes that also define `settle` — the
    _ExecJob / _TreeExecJob / _ShardedExecJob dispatch/settle split; a
    bare function named `dispatch` is NOT scanned;
  * `__init__` of a class that defines `settle` but no `dispatch`
    (_QueryManyJob dispatches at construction).

Flagged constructs:
  * the host copies and waits: `.item()`, `.tolist()`, `.cpu()`,
    `.numpy()`, `.to("cpu")` / `.to(device="cpu")`,
    `torch.cuda.synchronize()` and `.synchronize()` on an event or a
    stream, and a `.wait()` with no argument (`_Staged.wait()`, a
    host-blocking wait; `Event.wait(stream)` orders streams on the card
    and passes);
  * the fetch helpers `fetch` / `fetch_many` / `retried_fetch`;
  * `np.asarray` / `np.array` (host arrays of device values);
  * builtin float()/int()/bool() coercions.
`stage_many`, which only queues non-blocking copies, is allowed.  A
coercion of a genuinely host-side value is a legitimate keep: suppress
per file or grandfather it in the baseline with its justification.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from das_tpu_torch.analysis.core import AnalysisContext, Finding, attr_chain, const_str, register

#: methods that copy a tensor to the host or wait for the card
SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy", "synchronize"))
#: the port's fetch helpers (query/fused.py): each one waits for a round
FETCH_HELPERS = frozenset(("fetch", "fetch_many", "retried_fetch"))
_NUMPY_CALLS = frozenset((
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
))
_BANNED_BUILTINS = frozenset(("float", "int", "bool"))


def _is_cpu_device(node: ast.AST) -> bool:
    """"cpu" or torch.device("cpu")."""
    if const_str(node) == "cpu":
        return True
    return (
        isinstance(node, ast.Call)
        and attr_chain(node.func) in ("torch.device", "device")
        and bool(node.args) and const_str(node.args[0]) == "cpu"
    )


def transfer(node: ast.Call) -> Optional[str]:
    """The host transfer or wait `node` performs, rendered, or None:
    DL001's set less the numpy constructors and the builtin coercions,
    which match host arithmetic as often as device values (DL010 and
    DL013 share this set)."""
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in SYNC_METHODS:
            return f".{func.attr}()"
        if func.attr == "wait" and not node.args and not node.keywords:
            return ".wait()"
        if func.attr == "to" and (
            (node.args and _is_cpu_device(node.args[0]))
            or any(k.arg == "device" and _is_cpu_device(k.value)
                   for k in node.keywords)
        ):
            return '.to("cpu")'
        if func.attr in FETCH_HELPERS:
            return f"{func.attr}()"
    elif isinstance(func, ast.Name) and func.id in FETCH_HELPERS:
        return f"{func.id}()"
    return None


def banned(node: ast.Call) -> Optional[str]:
    """DL001's whole set: `transfer` plus the numpy constructors and the
    builtin coercions."""
    what = transfer(node)
    if what is not None:
        return what
    chain = attr_chain(node.func)
    if chain in _NUMPY_CALLS:
        return f"{chain}()"
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in _BANNED_BUILTINS
        and node.args
    ):
        return f"{node.func.id}() coercion"
    return None


def dispatch_functions(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    """(qualified name, def node) for every dispatch-path function."""
    out: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, cls: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
                is_dispatch = (
                    name in ("dispatch_many", "dispatch_pending")
                    or name.endswith("_dispatch")
                )
                if (
                    name in ("dispatch", "__init__")
                    and cls
                    and isinstance(node, ast.ClassDef)
                ):
                    methods = {
                        m.name for m in node.body
                        if isinstance(m, ast.FunctionDef)
                    }
                    if name == "dispatch":
                        is_dispatch = "settle" in methods
                    else:  # __init__ dispatches when there is no dispatch()
                        is_dispatch = (
                            "settle" in methods and "dispatch" not in methods
                        )
                if is_dispatch:
                    out.append(
                        (f"{cls}.{name}" if cls else name, child)
                    )
                else:
                    visit(child, cls)  # nested defs may still qualify

    visit(tree, "")
    return out


def _banned_in(fn: ast.AST) -> Iterable[Tuple[int, str]]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            what = banned(node)
            if what is not None:
                yield node.lineno, what


@register("DL001", "host sync on a dispatch path")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    for sf in ctx.modules():
        for qname, fn in dispatch_functions(sf.tree):
            for lineno, what in _banned_in(fn):
                yield Finding(
                    "DL001", sf.posix, lineno,
                    f"{what} inside dispatch-path function `{qname}` — "
                    "dispatch must stay transfer-free; host "
                    "synchronization belongs in the settle half",
                )
