"""DL016 — program-construction sites vs the PROGRAM_SITES registry.

Contract (obs/proflog.py): the program ledger's coverage claim — "every
program the serving path runs, and every library it builds, is
observable: first-call time, bytes, hits" — is only as good as the
registry.  The port compiles no device programs; its counterparts are:

  * the **program functions**: the `run_*` / `build_*` functions whose
    first parameter is a frozen `*Sig` (query/fused.py `run_conj`,
    `run_exact`, `build_fused_tree`; parallel/fused_sharded.py
    `run_sharded_conj`, `build_sharded_tree_fused`) — a plan's eager
    launches, keyed by its signature;
  * the **library loads**: `ctypes.CDLL(...)` of a library the port
    built (kernels/launch.py `library`, the nvcc build; ingest/native.py
    `get_lib`, the g++ build);
  * the **kernel launches**, noted by `launch.noted` (their wrappers are
    DL011's to keep routed through it).

`PROGRAM_SITES` maps every scope that feeds the ledger — attributed to
its OUTERMOST enclosing function, module-qualified ("fused._ExecJob.
dispatch", "launch.library") — to its ledger site label;
`PROGRAM_INNER_SITES` maps the scopes that reference a program function
only to run it INSIDE another site's instrumented program (the tree
builders, count_batch's lanes) to that site's label.  Legs:

  * a program-function reference or a library load in a scope declared
    in neither registry fails lint — every program stays a reviewed
    decision in one list;
  * a PROGRAM_SITES scope must contain a ledger hook call
    (`instrument(...)` / `record_launch(...)` / `record_build(...)`)
    passing EXACTLY its label literal — an instrumented site cannot
    silently drop its ledger coverage;
  * every hook label literal anywhere, and every PROGRAM_INNER_SITES
    label, must be a declared PROGRAM_SITES label — a typo'd site records
    into a lane nobody aggregates;
  * a reference or load outside any function (import time) fails;
  * a declared scope with neither a reference, a load nor a hook call
    is a stale entry (full-set runs only).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set, Tuple

from das_tpu_torch.analysis.callgraph import scope_module
from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    attr_chain,
    const_str,
    module_assign,
    register,
)

#: library-load calls
_LOAD_CHAINS = frozenset(("ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary"))

#: ledger hook call names whose first string argument is a site label
_HOOK_CALLS = frozenset(("instrument", "record_launch", "record_build"))


def _label_dict(sf, name: str) -> Optional[Dict[str, Optional[str]]]:
    node = module_assign(sf.tree, name)
    if not isinstance(node, ast.Dict):
        return None
    out: Dict[str, Optional[str]] = {}
    for k, v in zip(node.keys, node.values):
        key = const_str(k) if k is not None else None
        if key is None:
            return None
        out[key] = const_str(v)
    return out


def _find_registry(ctx: AnalysisContext):
    """(SourceFile, {scope: label}, {scope: label}) of the first module
    declaring PROGRAM_SITES as a dict of literals."""
    for sf in ctx.modules():
        sites = _label_dict(sf, "PROGRAM_SITES")
        if sites is not None:
            return sf, sites, _label_dict(sf, "PROGRAM_INNER_SITES") or {}
    return None


def program_functions(ctx: AnalysisContext) -> Set[str]:
    """Names of the `run_*` / `build_*` functions whose first parameter is
    annotated with a `*Sig` class."""
    out = set()
    for sf in ctx.modules():
        for node in sf.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not node.name.startswith(("run_", "build_")):
                continue
            args = node.args.posonlyargs + node.args.args
            ann = args[0].annotation if args else None
            name = getattr(ann, "id", getattr(ann, "attr", None))
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                name = ann.value.rsplit(".", 1)[-1]
            if name is not None and name.endswith("Sig"):
                out.add(node.name)
    return out


def _refs(root: ast.AST, programs: Set[str], skip_defs: bool) -> Iterable[Tuple[int, str]]:
    """(line, what) of every program-function reference and library load
    under `root` (nested defs too, unless `skip_defs`)."""
    stack = [root]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if skip_defs and isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(child, ast.Name) and child.id in programs \
                    and isinstance(child.ctx, ast.Load):
                yield child.lineno, f"program `{child.id}`"
            elif isinstance(child, ast.Attribute) and child.attr in programs:
                yield child.lineno, f"program `{child.attr}`"
            elif isinstance(child, ast.Call) and attr_chain(child.func) in _LOAD_CHAINS:
                yield child.lineno, "library load"
            stack.append(child)


def _outermost_scopes(sf) -> Iterable[Tuple[str, ast.AST]]:
    mod = scope_module(sf)

    def walk(node: ast.AST, classes):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, classes + [child.name])
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield ".".join([mod] + classes + [child.name]), child
            else:
                yield from walk(child, classes)

    yield from walk(sf.tree, [])


def _hook_literals(fn: ast.AST) -> Iterable[Tuple[int, str]]:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None
        )
        if name in _HOOK_CALLS and node.args:
            lit = const_str(node.args[0])
            if lit is not None:
                yield node.lineno, lit


def _registry_line(sf, name: str) -> int:
    for n in sf.tree.body:
        targets = n.targets if isinstance(n, ast.Assign) else (
            [n.target] if isinstance(n, ast.AnnAssign) else [])
        if any(getattr(t, "id", None) == name for t in targets):
            return n.lineno
    return 1


@register("DL016", "program-construction sites vs PROGRAM_SITES registry")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    registry = _find_registry(ctx)
    programs = program_functions(ctx)
    labels: Set[str] = set()
    if registry is not None:
        labels = {v for v in registry[1].values() if v is not None}
    used_scopes: Set[str] = set()
    wanted = programs | _HOOK_CALLS | {"CDLL", "LoadLibrary"}
    for sf in ctx.modules():
        if not (sf.names & wanted):
            continue
        for line, what in _refs(sf.tree, programs, skip_defs=True):
            yield Finding(
                "DL016", sf.posix, line,
                f"{what} referenced outside any function — import-time "
                "program construction has no declarable PROGRAM_SITES "
                "scope; move it into a declared builder",
            )
        for scope, fn in _outermost_scopes(sf):
            refs = list(_refs(fn, programs, skip_defs=False))
            hooks = list(_hook_literals(fn))
            if hooks:
                used_scopes.add(scope)
            for line, lit in hooks:
                if registry is not None and lit not in labels:
                    yield Finding(
                        "DL016", sf.posix, line,
                        f"ledger hook label {lit!r} is not a declared "
                        f"PROGRAM_SITES label ({registry[0].short}) — a "
                        "typo'd site records into an aggregate nobody "
                        "reads while the declared lane goes silent",
                    )
            if not refs:
                continue
            used_scopes.add(scope)
            if registry is None:
                yield Finding(
                    "DL016", sf.posix, refs[0][0],
                    f"{refs[0][1]} but no PROGRAM_SITES registry in the "
                    "analyzed set (das_tpu_torch/obs/proflog.py declares it)",
                )
                continue
            _rsf, sites, inner = registry
            if scope in inner:
                continue
            if scope not in sites:
                yield Finding(
                    "DL016", sf.posix, refs[0][0],
                    f"{refs[0][1]} in undeclared scope `{scope}` — every "
                    "program and library load must be declared in "
                    f"PROGRAM_SITES ({registry[0].short}) with its ledger "
                    "label, or in PROGRAM_INNER_SITES with the label of the "
                    "instrumented program it runs inside, or its first-call "
                    "time and bytes silently go dark",
                )
                continue
            label = sites[scope]
            if label is not None and label not in {lit for _l, lit in hooks}:
                yield Finding(
                    "DL016", sf.posix, refs[0][0],
                    f"scope `{scope}` is declared as ledger-instrumented "
                    f"(label {label!r}) but contains no instrument/"
                    "record_launch/record_build call passing that label — "
                    "its programs would run unobserved while the registry "
                    "promises coverage",
                )
    if registry is None:
        return
    reg_sf, sites, inner = registry
    for scope, label in inner.items():
        if label not in labels:
            yield Finding(
                "DL016", reg_sf.posix, _registry_line(reg_sf, "PROGRAM_INNER_SITES"),
                f"PROGRAM_INNER_SITES gives `{scope}` the label {label!r}, "
                "which no PROGRAM_SITES scope declares",
            )
    if ctx.partial:
        return
    for name, declared in (("PROGRAM_SITES", sites), ("PROGRAM_INNER_SITES", inner)):
        line = _registry_line(reg_sf, name)
        for scope in declared:
            if scope not in used_scopes:
                yield Finding(
                    "DL016", reg_sf.posix, line,
                    f"{name} declares `{scope}` but no program, library "
                    "load or ledger hook lives there — stale entry (the "
                    "builder moved, got renamed, or stopped constructing "
                    "programs)",
                )
