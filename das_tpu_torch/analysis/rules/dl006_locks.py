"""DL006 — lock discipline of threaded state.

Contract (service/coalesce.py, obs/recorder.py, obs/proflog.py): the
coalescer is one worker
thread plus N RPC threads.  Its correctness story is explicit —
`_worker` spawn races are serialized by `_lock`, everything else
mutable is confined to the single worker thread — but nothing enforced
it: a future edit that bumps `stats` from `submit()` (an RPC thread) or
re-spawns the worker without the lock introduces a data race that no
CPython test reliably catches.  The trace recorder and the program
ledger are shared by the worker, RPC threads and builders alike, and
every one of their post-construction writes holds their `_lock`.

Mechanism: a module declares its discipline next to the class it
covers, and this rule pins every post-__init__ attribute MUTATION
(assign / augmented-assign / subscript-assign on `self.<attr>`, method
calls like `.append()` excluded) against it:

    LOCK_DISCIPLINE = {
        "QueryCoalescer._worker": "_lock",   # only under `with self._lock:`
        "QueryCoalescer.stats":   "worker",  # only in WORKER_METHODS
    }
    WORKER_METHODS = {
        "QueryCoalescer": ("_run", "_group_batch", ...),
    }

Semantics per map value:
  * a lock attribute name ("_lock"): the mutation must be lexically
    inside `with self.<lock>:`;
  * "worker": the enclosing method must be in WORKER_METHODS[cls] —
    thread confinement, the lock-free single-consumer idiom;
  * "init": never mutated after __init__.

`__init__` assignments are always exempt (the object is not shared
yet).  A post-init mutation of an attribute with NO map entry is itself
a finding: new mutable state must declare who may touch it.  Modules
without a LOCK_DISCIPLINE are skipped — the rule is opt-in per module,
and tests/test_torch_lint.py pins that the three modules declare one.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    const_str,
    module_assign,
    register,
    str_collection,
)


def _parse_discipline(sf) -> Optional[Tuple[Dict[str, str], Dict[str, Tuple[str, ...]]]]:
    node = module_assign(sf.tree, "LOCK_DISCIPLINE")
    if not isinstance(node, ast.Dict):
        return None
    discipline: Dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        key = const_str(k) if k is not None else None
        val = const_str(v)
        if key is not None and val is not None:
            discipline[key] = val
    workers: Dict[str, Tuple[str, ...]] = {}
    wnode = module_assign(sf.tree, "WORKER_METHODS")
    if isinstance(wnode, ast.Dict):
        for k, v in zip(wnode.keys, wnode.values):
            key = const_str(k) if k is not None else None
            methods = str_collection(v)
            if key is not None and methods is not None:
                workers[key] = methods
    return discipline, workers


def _self_attr_target(node: ast.AST) -> Optional[str]:
    """`self.x = ...` or `self.x[...] = ...` -> "x"."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    if isinstance(node, ast.Subscript):
        return _self_attr_target(node.value)
    return None


def _mutations(
    stmts: List[ast.stmt], held: Tuple[str, ...]
) -> Iterable[Tuple[str, int, Tuple[str, ...]]]:
    """(attr, line, locks lexically held) for each self-attr mutation in
    a statement list, tracked through nested With blocks and the other
    compound statements (if/for/while/try)."""
    for node in stmts:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested defs: separate (deferred) execution context
        if isinstance(node, (ast.With, ast.AsyncWith)):
            now = held
            for item in node.items:
                ctx_attr = _self_attr_target(item.context_expr)
                if ctx_attr is not None:
                    now = now + (ctx_attr,)
            yield from _mutations(node.body, now)
            continue
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            attr = _self_attr_target(t)
            if attr is not None:
                yield attr, node.lineno, held
        for fname in ("body", "orelse", "finalbody"):
            sub = getattr(node, fname, None)
            if sub:
                yield from _mutations(sub, held)
        for handler in getattr(node, "handlers", []):
            yield from _mutations(handler.body, held)
        for case in getattr(node, "cases", []):  # ast.Match
            yield from _mutations(case.body, held)


@register("DL006", "declared lock discipline for threaded state")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    for sf in ctx.modules():
        parsed = _parse_discipline(sf)
        if parsed is None:
            continue
        discipline, workers = parsed
        # every class in a declaring module is covered: "new mutable
        # state must declare its owner" has to include new classes, or
        # threaded state dodges the rule by moving next door
        for node in sf.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            worker_methods = workers.get(node.name, ())
            for method in node.body:
                if not isinstance(
                    method, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if method.name == "__init__":
                    continue
                for attr, line, held in _mutations(method.body, ()):
                    spec = discipline.get(f"{node.name}.{attr}")
                    if spec is None:
                        yield Finding(
                            "DL006", sf.posix, line,
                            f"`self.{attr}` mutated in "
                            f"{node.name}.{method.name} but has no "
                            "LOCK_DISCIPLINE entry — declare which lock "
                            "(or thread) owns it",
                        )
                    elif spec == "init":
                        yield Finding(
                            "DL006", sf.posix, line,
                            f"`self.{attr}` is declared init-only but "
                            f"mutated in {node.name}.{method.name}",
                        )
                    elif spec == "worker":
                        if method.name not in worker_methods:
                            yield Finding(
                                "DL006", sf.posix, line,
                                f"`self.{attr}` is worker-thread-confined "
                                f"but {node.name}.{method.name} is not in "
                                "WORKER_METHODS — cross-thread mutation",
                            )
                    else:  # a lock attribute name
                        if spec not in held:
                            yield Finding(
                                "DL006", sf.posix, line,
                                f"`self.{attr}` mutated outside `with "
                                f"self.{spec}:` in "
                                f"{node.name}.{method.name}",
                            )
