"""DL011 — the kernel-entry contract.

Contract (ROADMAP "No kernel switch", "Build route (b)"; kernels/):
`das_tpu`'s DL011 kept its Pallas bodies ready for the Mosaic lowering,
the one compiler its CPU suite never ran.  The port's kernels are CUDA
C++ that the CPU suite never compiles either, and what must hold
instead is the route from a tensor to a kernel:

  * **every entry is bound** — each `extern "C"` function of
    `kernels/csrc/` is declared with its argument types in
    `kernels/launch.py` `_SIGNATURES` (ctypes passes an undeclared
    pointer as a 32-bit int), and every bound name exists in the
    sources (a stale binding fails only when the library loads, on the
    card);
  * **every launch is counted** — a launching entry (one whose result
    is the int error code: not in `_RESTYPES`, which holds the scratch
    queries and the error-name lookup) is called only inside a wrapper
    that records the launch: `launch.noted(...)` for the program ledger
    and `launch.count_call(...)` (or `LAUNCH_COUNTS[...] +=`) for the
    launch counts chip_smoke.py reads.  A launch outside one is work the
    card does that no count shows;
  * **no fallback** — no `try` statement around a launch in
    `kernels/`, and nowhere a `try` whose body calls a kernel wrapper and
    whose handler calls a `*_plain` version: a CUDA tensor goes to the
    kernel or the call raises, it never quietly takes the plain path;
  * **no sort on the card's branch** — the kernels were designed without
    sorts (stable grouping, hash sets, warp searches); a wrapper's CUDA
    branch (its body past the `if not launch.is_cuda(...)` plain branch,
    and the kernels/ helpers it calls) runs no `torch.sort` / `argsort` /
    `searchsorted` / `cumsum` / `unique` (nor their tensor methods): one
    there is a library kernel on the path the smoke holds against the
    hand-written one.

Scope: the binding legs run when CUDA sources and a `_SIGNATURES` dict
are both in the analyzed set; the launch legs run on every module; the
branch leg on the functions of modules under a `kernels/` directory
that call a launching entry.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from das_tpu_torch.analysis.callgraph import callgraph
from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    attr_chain,
    const_str,
    module_assign,
    register,
)
from das_tpu_torch.analysis.cuda import model

#: library calls that sort or scan: the card's branch of a wrapper runs
#: none of them
SORT_CALLS = frozenset((
    "sort", "argsort", "searchsorted", "cumsum", "unique", "unique_consecutive",
    "msort", "topk", "kthvalue",
))

#: the kernel wrappers of `das_tpu_torch.kernels`, the names a fallback
#: would wrap in a try
WRAPPER_NAMES = frozenset((
    "probe_term_tables", "probe_term_table", "join_tables", "index_join",
    "anti_join", "multiway_join",
))


def _bindings(ctx: AnalysisContext):
    """(SourceFile, line, {entry: line}, non-launching entries) of the
    first module declaring `_SIGNATURES`, or None."""
    for sf in ctx.modules():
        node = module_assign(sf.tree, "_SIGNATURES")
        if not isinstance(node, ast.Dict):
            continue
        bound = {}
        for k in node.keys:
            name = const_str(k) if k is not None else None
            if name is not None:
                bound[name] = k.lineno
        quiet: Set[str] = set()
        rnode = module_assign(sf.tree, "_RESTYPES")
        if isinstance(rnode, ast.Dict):
            quiet = {const_str(k) for k in rnode.keys if k is not None} - {None}
        return sf, node.lineno, bound, quiet
    return None


def _outermost(tree: ast.Module) -> Iterable[Tuple[str, ast.AST]]:
    def walk(node, classes):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, classes + [child.name])
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield ".".join(classes + [child.name]), child
            else:
                yield from walk(child, classes)

    yield from walk(tree, [])


def _calls_named(fn: ast.AST, names) -> List[ast.Call]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name in names:
                out.append(node)
    return out


def _counts_launch(fn: ast.AST) -> bool:
    if _calls_named(fn, ("count_call",)):
        return True
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript):
            base = node.target.value
            if getattr(base, "id", getattr(base, "attr", None)) == "LAUNCH_COUNTS":
                return True
    return False


def _is_cuda_test(test: ast.AST) -> bool:
    """`not launch.is_cuda(x)` / `not is_cuda(x)`: the plain branch."""
    return (
        isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
        and isinstance(test.operand, ast.Call)
        and (attr_chain(test.operand.func) or "").endswith("is_cuda")
    )


def _cuda_branch(fn: ast.AST) -> List[ast.stmt]:
    """The wrapper's statements with its plain branch left out."""
    return [
        s for s in fn.body
        if not (isinstance(s, ast.If) and _is_cuda_test(s.test))
    ]


def _sort_calls(nodes: Iterable[ast.AST]) -> Iterable[Tuple[int, str]]:
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in SORT_CALLS:
                yield node.lineno, attr_chain(node.func) or f".{node.func.attr}"


def _in_kernels(sf) -> bool:
    return "kernels" in sf.path.parts[:-1]


@register("DL011", "kernel-entry contract: bound, counted, no fallback, no sort")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    found = _bindings(ctx)
    entries: Dict[str, Tuple[object, int]] = {}
    for cf in ctx.cuda_files:
        for line, name in model(cf).entries:
            entries.setdefault(name, (cf, line))
    if found is not None and ctx.cuda_files:
        bsf, bline, bound, _quiet = found
        for name, (cf, line) in sorted(entries.items()):
            if name not in bound:
                yield Finding(
                    "DL011", cf.posix, line,
                    f"extern \"C\" entry `{name}` is not bound in "
                    f"_SIGNATURES ({bsf.short}) — ctypes would pass its "
                    "pointers and 64-bit sizes as 32-bit ints",
                )
        for name, line in sorted(bound.items()):
            if name not in entries and not ctx.partial:
                yield Finding(
                    "DL011", bsf.posix, line,
                    f"_SIGNATURES binds `{name}` but no CUDA source defines "
                    "it — a stale binding fails only when the library "
                    "loads, on the card",
                )
    if found is None:
        return
    _bsf, _bline, bound, quiet = found
    launching = set(bound) - quiet
    graph = callgraph(ctx)
    for sf in ctx.modules():
        if not (sf.names & (launching | WRAPPER_NAMES)):
            continue
        for qual, fn in _outermost(sf.tree):
            launches = [
                c for c in _calls_named(fn, launching)
                if isinstance(c.func, ast.Attribute)
            ]
            if launches:
                if not (_calls_named(fn, ("noted",)) and _counts_launch(fn)):
                    yield Finding(
                        "DL011", sf.posix, launches[0].lineno,
                        f"kernel entry `{launches[0].func.attr}` launched in "
                        f"`{qual}`, which does not record the launch "
                        "(launch.noted and launch.count_call) — the card "
                        "would do work that no count shows",
                    )
                if _in_kernels(sf):
                    yield from _branch_findings(graph, sf, qual, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Try):
                    continue
                body_launch = _calls_named(
                    ast.Module(body=node.body, type_ignores=[]), launching
                )
                if body_launch and _in_kernels(sf):
                    yield Finding(
                        "DL011", sf.posix, node.lineno,
                        f"try statement around a kernel launch in `{qual}` — "
                        "a CUDA tensor goes to the kernel or the call raises; "
                        "nothing may catch a launch's failure",
                    )
                    continue
                wraps = _calls_named(
                    ast.Module(body=node.body, type_ignores=[]), WRAPPER_NAMES
                )
                plain = [
                    c for h in node.handlers
                    for c in _calls_named(ast.Module(body=h.body, type_ignores=[]),
                                          _plain_names(h))
                ]
                if wraps and plain:
                    yield Finding(
                        "DL011", sf.posix, node.lineno,
                        f"`{qual}` falls back to a plain version when a kernel "
                        "wrapper raises — a CUDA tensor goes to the kernel or "
                        "the call raises, it never quietly takes the plain path",
                    )


def _plain_names(handler: ast.ExceptHandler) -> Set[str]:
    out = set()
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name and name.endswith("_plain"):
                out.add(name)
    return out


def _branch_findings(graph, sf, qual, fn) -> Iterable[Finding]:
    branch = _cuda_branch(fn)
    for line, what in _sort_calls(branch):
        yield Finding(
            "DL011", sf.posix, line,
            f"{what}() on the CUDA branch of kernel wrapper `{qual}` — the "
            "card's path runs the hand-written kernel, no library sort or "
            "scan",
        )
    # the kernels/ helpers the branch calls, transitively
    cls = qual.split(".")[0] if "." in qual else None
    calls = [
        (node.lineno, graph.resolve_call(sf, node, cls))
        for stmt in branch for node in ast.walk(stmt) if isinstance(node, ast.Call)
    ]
    seen: Set[str] = set()
    for line, q in calls:
        if q is None or q not in graph.functions:
            continue
        info = graph.functions[q]
        if not _in_kernels(info.sf) or q in seen:
            continue
        seen.add(q)
        reach = [(info, ((line, q),))] + list(
            graph.walk(info.sf, info.node, info.class_name,
                       stop=lambda i: not _in_kernels(i.sf))
        )
        for hinfo, _path in reach:
            if hinfo.qname in seen and hinfo is not info:
                continue
            seen.add(hinfo.qname)
            for hline, what in _sort_calls([hinfo.node]):
                yield Finding(
                    "DL011", sf.posix, line,
                    f"{what}() at {hinfo.sf.short}:{hline} is reached from "
                    f"the CUDA branch of kernel wrapper `{qual}` — the "
                    "card's path runs the hand-written kernel, no library "
                    "sort or scan",
                )

