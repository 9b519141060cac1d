"""DL009 — collective discipline of the mesh.

Contract (parallel/mesh.py): data crosses shards only through the
mesh's four collectives — `all_gather`, `all_to_all`, `psum`, `pmax` —
and where they may run is a closed, declared set:

  * NEVER inside das_tpu_torch/kernels/ — a kernel wrapper is
    SHARD-LOCAL by design (the sharded executor calls it once per local
    slab, on that slab's device).  A collective there would make every
    rank's launch wait on the others, or deadlock when one rank takes a
    different path: invisible on the single-process CPU suite;
  * everywhere else a mesh collective runs only inside the scopes
    declared in `COLLECTIVE_SITES` (parallel/mesh.py) — the sharded
    executor's and tree's helpers whose cross-shard traffic IS their
    purpose, kept in one reviewable list;
  * a `torch.distributed` collective (`dist.all_reduce`,
    `dist.all_gather`, `dist.all_to_all_single`, `dist.broadcast`, ...)
    runs only inside the mesh's own helpers, declared in
    `COLLECTIVE_HELPERS` beside COLLECTIVE_SITES: they are where a
    collective is DEFINED — the local reduction or concatenation, then
    one call across the processes, staged and counted in
    COLLECTIVE_STATS.  A raw `dist.*` call anywhere else bypasses that
    staging, the counting and the every-rank-the-same-order contract.

A call to a name in MESH_COLLECTIVES is a mesh collective unless its
receiver is `torch.distributed` (by import alias or spelled out), in
which case it is a process-group collective.  Attribution: a call is
charged to its OUTERMOST enclosing scope — leading class names plus the
first function name, qualified by the module stem
("fused_sharded._repartition", "mesh.all_gather") — so nested closure
bodies (`gather`, `exchange`, `reduce`) charge to the helper that owns
them.  Both directions are pinned for both registries: an undeclared
call fails lint, and a declared scope that no longer makes one is a
stale entry.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from das_tpu_torch.analysis.callgraph import module_table
from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    attr_chain,
    module_assign,
    register,
    str_collection,
)

#: the mesh's cross-shard collectives (parallel/mesh.py), and the XLA
#: names `das_tpu` used beside them
MESH_COLLECTIVES = frozenset((
    "all_gather", "all_to_all", "psum", "pmax", "pmin", "ppermute", "psum_scatter",
))

#: torch.distributed's data-moving calls
DIST_COLLECTIVES = frozenset((
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather", "scatter",
    "send", "recv", "isend", "irecv", "barrier",
))

_DIST_MODULE = "torch.distributed"

_ALL_COLLECTIVES = MESH_COLLECTIVES | DIST_COLLECTIVES


def _find_registry(ctx: AnalysisContext, name: str):
    for sf in ctx.modules():
        keys = str_collection(module_assign(sf.tree, name))
        if keys is not None:
            return sf, keys
    return None


def _dist_aliases(sf) -> Set[str]:
    """Local names bound to torch.distributed in this module."""
    out = {_DIST_MODULE}
    for local, target in module_table(sf).imports.items():
        if target == _DIST_MODULE:
            out.add(local)
    return out


def _classify(node: ast.Call, dist_names: Set[str]) -> Optional[Tuple[str, str]]:
    """("dist", name) for a torch.distributed collective, ("mesh", name)
    for a mesh collective, else None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        recv = attr_chain(fn.value)
        if recv in dist_names:
            return ("dist", fn.attr) if fn.attr in DIST_COLLECTIVES else None
        if fn.attr in MESH_COLLECTIVES:
            return "mesh", fn.attr
    elif isinstance(fn, ast.Name) and fn.id in MESH_COLLECTIVES:
        return "mesh", fn.id
    return None


def _in_kernels(sf) -> bool:
    return "kernels" in sf.path.parts[:-1]


def _collective_sites(sf) -> Iterable[Tuple[int, str, str, str]]:
    """(line, kind, collective name, outermost qualified scope) per call."""
    dist_names = _dist_aliases(sf)

    def walk(node: ast.AST, classes: List[str], func: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                # a class nested under a function charges to the func
                yield from walk(
                    child,
                    (classes + [child.name]) if func is None else classes,
                    func,
                )
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(
                    child, classes,
                    func if func is not None else child.name,
                )
            else:
                if isinstance(child, ast.Call):
                    hit = _classify(child, dist_names)
                    if hit is not None:
                        scope = (
                            ".".join([sf.name] + classes + [func])
                            if func is not None else "<module>"
                        )
                        yield child.lineno, hit[0], hit[1], scope
                yield from walk(child, classes, func)

    yield from walk(sf.tree, [], None)


def _registry_line(sf, name: str) -> int:
    return next(
        (
            n.lineno for n in sf.tree.body
            if isinstance(n, ast.Assign)
            and any(getattr(t, "id", None) == name for t in n.targets)
        ),
        1,
    )


@register("DL009", "mesh collective discipline")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    registries = {
        "mesh": ("COLLECTIVE_SITES", _find_registry(ctx, "COLLECTIVE_SITES")),
        "dist": ("COLLECTIVE_HELPERS", _find_registry(ctx, "COLLECTIVE_HELPERS")),
    }
    used = {"mesh": set(), "dist": set()}
    any_calls = {"mesh": False, "dist": False}
    for sf in ctx.modules():
        if not (sf.names & _ALL_COLLECTIVES):
            continue
        kernels_file = _in_kernels(sf)
        for line, kind, name, scope in _collective_sites(sf):
            any_calls[kind] = True
            what = f"collective `{name}`" if kind == "mesh" else \
                f"torch.distributed collective `{name}`"
            if kernels_file:
                yield Finding(
                    "DL009", sf.posix, line,
                    f"{what} inside a shard-local kernel wrapper "
                    "(das_tpu_torch/kernels/) — a wrapper runs once per "
                    "local slab; a collective here makes every launch wait "
                    "on the other ranks or deadlocks when one rank takes "
                    "another path",
                )
                continue
            reg_name, registry = registries[kind]
            if registry is None:
                yield Finding(
                    "DL009", sf.posix, line,
                    f"{what} but no {reg_name} registry in the analyzed "
                    "set (das_tpu_torch/parallel/mesh.py declares it)",
                )
                continue
            used[kind].add(scope)
            if scope not in registry[1]:
                if kind == "mesh":
                    hint = (
                        "mesh collectives belong in the declared helpers "
                        f"(COLLECTIVE_SITES, {registry[0].short}), where "
                        "every cross-shard byte stays reviewable in one list"
                    )
                else:
                    hint = (
                        "a process-group call belongs in the mesh's own "
                        f"collectives (COLLECTIVE_HELPERS, {registry[0].short}), "
                        "which stage it, count it in COLLECTIVE_STATS and keep "
                        "every rank's calls in the same order"
                    )
                yield Finding(
                    "DL009", sf.posix, line,
                    f"{what} in undeclared scope `{scope}` — {hint}",
                )
    # stale entries are only provable against the FULL set
    if ctx.partial:
        return
    for kind, (reg_name, registry) in registries.items():
        if registry is None or not any_calls[kind]:
            continue
        reg_sf, declared = registry
        line = _registry_line(reg_sf, reg_name)
        for scope in declared:
            if scope not in used[kind]:
                yield Finding(
                    "DL009", reg_sf.posix, line,
                    f"{reg_name} declares `{scope}` but no collective call "
                    "lives there — stale entry (the helper moved, got "
                    "renamed, or lost its collective)",
                )
