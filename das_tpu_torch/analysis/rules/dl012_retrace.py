"""DL012 — cache keying of the port's cached programs.

Contract (obs/proflog.py PROGRAM_SITES, query/fused.py): `das_tpu`
keyed every jitted program on its frozen `*Sig`, so a per-request value
slipping into a traced closure meant a recompile per query.  The port
compiles nothing per query, but it caches the same things by the same
keys — and a per-request value in a cached closure or key is now a
wrong answer replayed from the cache, or a cache that never hits:

  * the ledger's programs: `proflog.instrument(label, key, fn, ...)` in
    the PROGRAM_SITES scopes (`_ExecJob.dispatch`, `_TreeExecJob._build`,
    `execute_exact`, `_run_batch_group`, the sharded twins) keys every
    first-call record on `key`;
  * the built tree programs: `_TreeExecJob.dispatch` caches
    `self._build(tree_sig)` in the executor's `_tree_progs[tree_sig]`;
  * the kernel and scanner libraries: `launch.library` and
    `native.get_lib` load a library built once per digest of its
    sources and flags.

Legs (shape checks in the house style: they force the idiom where
review can see the keying, not prove a dataflow theorem):

  * **ledger keying** — the key argument of an `instrument(...)` call is
    a `sig_digest(...)` call whose first argument is signature-derived:
    a parameter annotated `*Sig` or named `*sig`, or a local assigned
    from a call whose callee's name ends in `sig` / `Sig`
    (`self.plan_sig()`, `make_sig(...)`, `FusedPlanSig(...)`);
  * **program-cache keying** — a subscript store `cache[key] = entry`
    of a built program (`entry` from a call of a program function —
    DL016's `build_*` / `run_*` taking a *Sig — or of a job's `_build`
    hook) keys it on a signature-derived name;
  * **per-request taint** — a parameter of the enclosing function chain
    annotated as a mutable container (`dict` / `list` / `set` / `Any`
    ...), defaulted to a mutable literal, or taken as `**kwargs` must not
    reach an `instrument` call's key or program function, nor the free
    variables of a closure defined in a `build_*` builder: those are the
    values whose content changes per request;
  * **library keying** — a function that loads a library
    (`ctypes.CDLL`) reaches, through its own body or the functions it
    calls, a `hashlib` digest: the path it loads is keyed by its
    sources, so a changed source cannot load a stale build.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from das_tpu_torch.analysis.callgraph import callgraph
from das_tpu_torch.analysis.core import AnalysisContext, Finding, attr_chain, register
from das_tpu_torch.analysis.rules.dl016_proflog_sites import program_functions

_MUTABLE_ANNOTATIONS = frozenset((
    "dict", "list", "set", "Dict", "List", "Set", "DefaultDict",
    "MutableMapping", "MutableSequence", "Any", "object",
))

_LOAD_CHAINS = frozenset(("ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary"))


def _ann_name(ann: Optional[ast.AST]) -> Optional[str]:
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Subscript):
        return _ann_name(ann.value)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1].split("[")[0]
    return None


def _params(fn: ast.AST) -> List[ast.arg]:
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs


def _banned_params(fn: ast.AST) -> Dict[str, str]:
    """param name -> why it is a per-request mutable origin."""
    out: Dict[str, str] = {}
    a = fn.args
    pos = a.posonlyargs + a.args
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if isinstance(d, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
            and d.func.id in ("dict", "list", "set")
        ):
            out[p.arg] = "mutable default"
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(d, (ast.Dict, ast.List, ast.Set)):
            out[p.arg] = "mutable default"
    for p in _params(fn):
        name = _ann_name(p.annotation)
        if name in _MUTABLE_ANNOTATIONS:
            out[p.arg] = f"param annotated `{name}`"
    if a.kwarg is not None:
        out[a.kwarg.arg] = "**kwargs"
    return out


def _taint(chain: List[ast.AST]) -> Dict[str, str]:
    """Banned params of the chain, propagated one pass through plain
    `x = banned` assignments."""
    out: Dict[str, str] = {}
    for fn in chain:
        out.update(_banned_params(fn))
    for fn in chain:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
                why = out.get(node.value.id)
                if why:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            out.setdefault(t.id, why)
    return out


def _names_in(e: ast.AST) -> Set[str]:
    return {
        n.id for n in ast.walk(e)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


def _free_names(fn: ast.AST) -> Set[str]:
    bound: Set[str] = {p.arg for p in _params(fn)}
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    loads: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loads.add(node.id)
            else:
                bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            bound.add(node.name)
    return loads - bound


def _callee(call: ast.Call) -> str:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _sig_name(name: str, chain: List[ast.AST]) -> bool:
    """`name` is signature-derived in the enclosing chain."""
    for fn in chain:
        for p in _params(fn):
            if p.arg == name and (
                (_ann_name(p.annotation) or "").endswith("Sig")
                or name.endswith("sig")
            ):
                return True
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name for t in node.targets)
                and isinstance(node.value, ast.Call)
                and _callee(node.value).lower().endswith("sig")
            ):
                return True
    return False


def _sig_expr(e: ast.AST, chain: List[ast.AST]) -> bool:
    if isinstance(e, ast.Name):
        return _sig_name(e.id, chain)
    if isinstance(e, ast.Call):
        return _callee(e).lower().endswith("sig")
    return False


def _chains(tree: ast.Module):
    """(node, chain of enclosing defs outermost-first) for every node."""

    def walk(node: ast.AST, chain: List[ast.AST]):
        for child in ast.iter_child_nodes(node):
            yield child, chain
            sub = chain + [child] if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else chain
            yield from walk(child, sub)

    yield from walk(tree, [])


def _is_builder(fn: ast.AST) -> bool:
    return fn.name.startswith(("build_", "_build")) and any(
        (_ann_name(p.annotation) or "").endswith("Sig") for p in _params(fn)
    )


def _builds(value: ast.AST, builders: Set[str]) -> bool:
    """`value` calls a program builder: a program function of DL016's
    (`build_*` / `run_*` taking a *Sig) or a job's `_build` hook."""
    return isinstance(value, ast.Call) and _callee(value) in builders


def _built_names(fn: ast.AST, builders: Set[str]) -> Set[str]:
    """Locals assigned a built program."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _builds(node.value, builders):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _hashes(graph, info_sf, node, cls) -> bool:
    def direct(fn):
        return any(
            isinstance(n, ast.Call) and (attr_chain(n.func) or "").startswith("hashlib.")
            for n in ast.walk(fn)
        )

    if direct(node):
        return True
    return any(direct(i.node) for i, _p in graph.walk(info_sf, node, cls))


@register("DL012", "cache keying of cached programs and libraries")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    graph = None
    builders = program_functions(ctx) | {"_build"}
    wanted = builders | {"instrument", "CDLL", "LoadLibrary"}
    for sf in ctx.modules():
        if not (sf.names & wanted) and not any(
            isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and _is_builder(n)
            for n in sf.tree.body
        ):
            continue
        for node, chain in _chains(sf.tree):
            if isinstance(node, ast.Call) and _callee(node) == "instrument" \
                    and len(node.args) >= 2:
                key = node.args[1]
                ok = (
                    isinstance(key, ast.Call) and _callee(key) == "sig_digest"
                    and bool(key.args) and _sig_expr(key.args[0], chain)
                )
                if not ok:
                    yield Finding(
                        "DL012", sf.posix, node.lineno,
                        "instrument(...) keyed by something other than "
                        "sig_digest(<signature>, ...) — a ledger program's "
                        "key must derive from its frozen *Sig, or every "
                        "request records a fresh 'first call'",
                    )
                tainted = _taint(chain)
                used = set()
                for a in node.args[1:] + [k.value for k in node.keywords]:
                    used |= _names_in(a)
                for name in sorted(used & set(tainted)):
                    yield Finding(
                        "DL012", sf.posix, node.lineno,
                        f"per-request mutable value `{name}` "
                        f"({tainted[name]}) reaches an instrument(...) "
                        "program or key — cached programs derive only from "
                        "frozen *Sig fields and constants",
                    )
            elif isinstance(node, ast.Assign) and chain:
                for t in node.targets:
                    if not isinstance(t, ast.Subscript):
                        continue
                    value = node.value
                    built = _builds(value, builders) or (
                        isinstance(value, ast.Name)
                        and value.id in _built_names(chain[-1], builders)
                    )
                    if built and not _sig_expr(t.slice, chain):
                        yield Finding(
                            "DL012", sf.posix, node.lineno,
                            "a built program cached under a key that is not "
                            "its signature — key program caches on the "
                            "frozen *Sig the builder took",
                        )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and chain and _is_builder(chain[-1]):
                tainted = _taint(chain)
                for name in sorted(_free_names(node) & set(tainted)):
                    yield Finding(
                        "DL012", sf.posix, node.lineno,
                        f"per-request mutable value `{name}` "
                        f"({tainted[name]}) is closed over by `{node.name}` "
                        f"in builder `{chain[-1].name}` — a built program's "
                        "closure derives only from its frozen *Sig and "
                        "constants",
                    )
            elif isinstance(node, ast.Call) and attr_chain(node.func) in _LOAD_CHAINS \
                    and chain:
                graph = graph or callgraph(ctx)
                outer = chain[0]
                cls = None
                for cnode in sf.tree.body:
                    if isinstance(cnode, ast.ClassDef) and outer in cnode.body:
                        cls = cnode.name
                if not _hashes(graph, sf, outer, cls):
                    yield Finding(
                        "DL012", sf.posix, node.lineno,
                        f"`{outer.name}` loads a library whose path no "
                        "digest of its sources keys — a changed source "
                        "would load a stale build",
                    )
