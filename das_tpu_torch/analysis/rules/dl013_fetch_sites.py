"""DL013 — fetch-site registry: every host transfer is declared and
tallied.

Contract (query/fused.py): the serving pipeline's latency story is the
count of host transfers — "one fetch per settle round", which
FETCH_COUNTS pins in the serving, tree and count suites.  That holds
only if the transfers are enumerable: a new `.cpu()` anywhere else (a
debug copy in a join helper, a convenience `.item()` on a count) adds a
wait for the card per query with no test failing.

The transfer calls are DL001's host copies and waits (`.item()`,
`.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")`, `.synchronize()`, a
blocking `.wait()`, and the fetch helpers `fetch` / `fetch_many` /
`retried_fetch`); the numpy constructors and the builtin coercions stay
DL001's own, since they match host arithmetic everywhere.
`FETCH_SITES` (query/fused.py, next to FETCH_COUNTS) maps the closed set
of scopes allowed to make one — attributed to their OUTERMOST enclosing
function, qualified by module stem ("fused.settle_pending_iter",
"sharded_db.ShardedDB.materialize"; `__init__` modules take their
package name, so planner/__init__.py is "planner") — to the tally that
counts its transfers ("FETCH_COUNTS", or starcount's "FETCHES"), or to
None for a transfer no fetch tally counts (a measurement sync, a copy
of host-resident data), its reason in the comment beside it.  Legs:

  * a transfer in an undeclared scope, or outside every function (an
    import-time transfer), fails lint;
  * a scope declared with a tally must be counted: it increments that
    tally itself, or every transfer in it is a call of a fetch helper
    whose own scope is declared and counted (`fetch` -> `fetch_many`,
    which counts) — the fetches-per-query telemetry cannot undercount;
  * a declared scope with no transfer is a stale entry (full-set runs
    only — a partial (--allow-partial) run may not include the module).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from das_tpu_torch.analysis.callgraph import scope_module
from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    const_str,
    module_assign,
    register,
)
from das_tpu_torch.analysis.rules.dl001_host_sync import FETCH_HELPERS, SYNC_METHODS, transfer

#: counter dicts that count as a fetch tally
TALLY_NAMES = frozenset(("FETCH_COUNTS", "FETCHES"))

#: a module mentioning none of these holds no transfer
_TRANSFER_NAMES = SYNC_METHODS | FETCH_HELPERS | {"wait", "to"}


def _find_registry(ctx: AnalysisContext):
    """(SourceFile, line, {scope: tally or None}) of the first module
    declaring FETCH_SITES as a dict, or None."""
    for sf in ctx.modules():
        node = module_assign(sf.tree, "FETCH_SITES")
        if not isinstance(node, ast.Dict):
            continue
        out: Dict[str, Optional[str]] = {}
        for k, v in zip(node.keys, node.values):
            key = const_str(k) if k is not None else None
            if key is None:
                continue
            out[key] = const_str(v)
        return sf, node.lineno, out
    return None


def _outermost_scopes(sf) -> Iterable[Tuple[str, ast.AST]]:
    """(qualified scope, def node) for every OUTERMOST function, class
    methods qualified ("mod.Class.meth") — the DL009 attribution."""
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


def _transfers(fn: ast.AST) -> List[Tuple[int, str, ast.Call]]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            what = transfer(node)
            if what is not None:
                out.append((node.lineno, what, node))
    return out


def _toplevel_transfers(sf) -> Iterable[Tuple[int, str]]:
    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(child, ast.Call):
                what = transfer(child)
                if what is not None:
                    yield child.lineno, what
            yield from walk(child)

    yield from walk(sf.tree)


def _tallies(fn: ast.AST) -> Set[str]:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Subscript):
            base = node.target.value
            name = base.id if isinstance(base, ast.Name) else (
                base.attr if isinstance(base, ast.Attribute) else None
            )
            if name in TALLY_NAMES:
                out.add(name)
    return out


def _callee_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute) and not isinstance(f.value, ast.Call):
        return f.attr
    return None


@register("DL013", "host-transfer sites vs FETCH_SITES registry")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    registry = _find_registry(ctx)
    used: Set[str] = set()
    sites: Dict[str, Tuple[object, ast.AST, List]] = {}
    any_transfer = False
    for sf in ctx.modules():
        if not (sf.names & _TRANSFER_NAMES):
            continue
        for line, what in _toplevel_transfers(sf):
            any_transfer = True
            yield Finding(
                "DL013", sf.posix, line,
                f"{what} outside any function (module/class body) — an "
                "import-time host transfer fires unconditionally and has "
                "no declarable FETCH_SITES scope; move it into a declared "
                "fetch function",
            )
        for scope, fn in _outermost_scopes(sf):
            found = _transfers(fn)
            if not found:
                continue
            any_transfer = True
            if registry is None:
                yield Finding(
                    "DL013", sf.posix, found[0][0],
                    f"{found[0][1]} but no FETCH_SITES registry in the "
                    "analyzed set (query/fused.py declares it, next to "
                    "FETCH_COUNTS)",
                )
                continue
            used.add(scope)
            if scope not in registry[2]:
                yield Finding(
                    "DL013", sf.posix, found[0][0],
                    f"{found[0][1]} in undeclared scope `{scope}` — every "
                    "host transfer waits for the card and must be declared "
                    f"in FETCH_SITES ({registry[0].short}) so the "
                    "one-fetch-per-settle-round contract stays reviewable",
                )
                continue
            sites[scope] = (sf, fn, found)
    if registry is None:
        return
    declared = registry[2]
    # counted scopes, to a fixpoint: a direct tally, or only calls of
    # counted fetch helpers
    counted: Set[str] = {
        s for s, (_sf, fn, _f) in sites.items()
        if declared.get(s) is not None and declared[s] in _tallies(fn)
    }
    while True:
        helpers = {s.rsplit(".", 1)[-1] for s in counted}
        more = {
            s for s, (_sf, _fn, found) in sites.items()
            if s not in counted and declared.get(s) is not None
            and all(_callee_name(c) in helpers for _l, _w, c in found)
        }
        if not more:
            break
        counted |= more
    for scope, (sf, _fn, found) in sorted(sites.items()):
        tally = declared.get(scope)
        if tally is not None and scope not in counted:
            yield Finding(
                "DL013", sf.posix, found[0][0],
                f"declared fetch scope `{scope}` pays a host transfer "
                f"without tallying {tally} — the fetches-per-query "
                "telemetry would undercount this site",
            )
    if any_transfer and not ctx.partial:
        reg_sf, line, _d = registry
        for scope in declared:
            if scope not in used:
                yield Finding(
                    "DL013", reg_sf.posix, line,
                    f"FETCH_SITES declares `{scope}` but no host transfer "
                    "lives there — stale entry (the function moved, got "
                    "renamed, or stopped fetching)",
                )
