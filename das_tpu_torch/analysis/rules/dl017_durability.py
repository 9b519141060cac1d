"""DL017 — durability discipline: persist writes via the atomic
helpers.

Contract (storage/durable.py): the recovery story — "a crash at any
point leaves either the complete new file/generation or the untouched
prior one" — holds only if EVERY byte written beneath the snapshot/WAL
root flows through the reviewed helpers (`atomic_write`,
`DeltaLog.append`, `_truncate_wal`, `_publish_generation`): write-temp
-> flush -> fsync -> rename, directory fsync after.  One bare
`open(path, "w")`, `np.savez(path)` or `torch.save(obj, path)` added to
a persist module re-opens the exact torn-file corruption the module
exists to close — and it would pass every test that doesn't kill the
process mid-write.

`PERSIST_SITES` (storage/durable.py) declares the CLOSED set of
functions allowed to open persist files for writing; `PERSIST_SCOPES`
declares which modules the discipline covers (matched by path suffix —
a module declaring its own PERSIST_SITES, e.g. a fixture, is a scope
too).  Legs:

  * a write-mode `open()` (w/a/x/+), or a `Path.write_text` /
    `write_bytes`, in a persist scope OUTSIDE a declared site fails lint;
  * `np.save` / `np.savez` / `np.savez_compressed` handed a PATH as its
    file (anything but a bare name bound to an approved writer's file
    object), and `torch.save` handed a path as its file (second
    argument or `f=`), in a persist scope fail — file handles flowing
    out of `atomic_write` are fine, paths bypass it;
  * fsync-before-rename: any declared site that calls
    `os.replace`/`os.rename` must call `os.fsync` on an EARLIER line —
    rename-without-fsync is the classic "atomic" write that loses the
    file on power-cut; a rename outside the declared set fires;
  * a declared site that performs no write at all is a STALE entry
    (full-set runs only — a partial (--allow-partial) subset may simply not
    include durable.py).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    const_str,
    module_assign,
    register,
    str_collection,
)

#: write-intent open() modes: any of these chars in the mode string
_WRITE_MODE_CHARS = frozenset("wax+")

#: numpy writers that accept a bare path as their first argument
_SAVEZ_NAMES = frozenset(("save", "savez", "savez_compressed"))

#: pathlib writers: each opens, writes and closes a file in one call
_PATH_WRITERS = frozenset(("write_text", "write_bytes"))


def _find_registry(ctx: AnalysisContext):
    """(SourceFile, sites tuple, scopes tuple) of the first module
    declaring PERSIST_SITES (storage/durable.py in the real tree;
    fixtures declare their own)."""
    for sf in ctx.modules():
        sites = str_collection(module_assign(sf.tree, "PERSIST_SITES"))
        if sites:
            scopes = str_collection(
                module_assign(sf.tree, "PERSIST_SCOPES")
            ) or ()
            return sf, sites, scopes
    return None


def _functions(tree: ast.Module):
    """(qualname, FunctionDef) for every function, methods as
    `Class.method` (the PERSIST_SITES naming)."""
    out: List[Tuple[str, ast.AST]] = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child))
                walk(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def _open_write_mode(call: ast.Call) -> bool:
    """True when this is an open() call with a write-intent mode."""
    fn = call.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None
    )
    if name != "open":
        return False
    mode = None
    if len(call.args) >= 2:
        mode = const_str(call.args[1])
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = const_str(kw.value)
    if mode is None:
        return False  # default "r" — reads are free
    return any(c in _WRITE_MODE_CHARS for c in mode)


def _os_call(call: ast.Call, names: Tuple[str, ...]) -> bool:
    fn = call.func
    return (
        isinstance(fn, ast.Attribute)
        and isinstance(fn.value, ast.Name)
        and fn.value.id == "os"
        and fn.attr in names
    )


def _savez_path_call(call: ast.Call) -> bool:
    """np.save*(...) whose first argument, or torch.save(...) whose
    second (`f=`), is NOT a bare name (i.e. a path literal / join /
    f-string): bypasses the atomic helper.  A bare name is a file object
    handed in by an approved writer."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    owner = fn.value.id if isinstance(fn.value, ast.Name) else None
    if owner == "torch" and fn.attr == "save":
        target = call.args[1] if len(call.args) >= 2 else next(
            (k.value for k in call.keywords if k.arg == "f"), None)
        return target is not None and not isinstance(target, ast.Name)
    if fn.attr not in _SAVEZ_NAMES or owner == "torch":
        return False
    if not call.args:
        return False
    return not isinstance(call.args[0], ast.Name)


def _scan(fn_node: ast.AST):
    """(write_opens, replaces, fsyncs, savez_paths) line lists of one
    function body (nested defs fold in — a helper closure inside a
    declared site inherits its license)."""
    opens: List[int] = []
    replaces: List[int] = []
    fsyncs: List[int] = []
    savez: List[int] = []
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        if _open_write_mode(node) or (
            isinstance(node.func, ast.Attribute) and node.func.attr in _PATH_WRITERS
        ):
            opens.append(node.lineno)
        if _os_call(node, ("replace", "rename")):
            replaces.append(node.lineno)
        if _os_call(node, ("fsync",)):
            fsyncs.append(node.lineno)
        if _savez_path_call(node):
            savez.append(node.lineno)
    return opens, replaces, fsyncs, savez


@register("DL017", "durability discipline: persist writes via atomic helpers")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    registry = _find_registry(ctx)
    if registry is None:
        return
    reg_sf, sites, scopes = registry
    declared: Set[str] = set(sites)
    used: Dict[str, bool] = {s: False for s in declared}
    for sf in ctx.modules():
        in_scope = sf is reg_sf or any(
            sf.posix.endswith(sc) for sc in scopes
        ) or str_collection(
            module_assign(sf.tree, "PERSIST_SITES")
        ) is not None
        if not in_scope:
            continue
        fn_nodes = _functions(sf.tree)
        covered: Set[int] = set()
        for qual, node in fn_nodes:
            opens, replaces, fsyncs, savez = _scan(node)
            for n in ast.walk(node):
                covered.add(getattr(n, "lineno", 0))
            if qual in declared:
                if opens or replaces or savez:
                    used[qual] = True
                # the fsync-before-rename pin: a site that renames a
                # file into place must have fsynced it first
                for line in replaces:
                    if not any(f < line for f in fsyncs):
                        yield Finding(
                            "DL017", sf.posix, line,
                            f"declared persist site `{qual}` calls "
                            "os.replace/os.rename with no earlier "
                            "os.fsync — rename-without-fsync loses the "
                            "file on power cut; fsync the temp file "
                            "(and the directory) first",
                        )
                continue
            for line in opens:
                yield Finding(
                    "DL017", sf.posix, line,
                    f"bare write-mode open() or Path write in persist scope "
                    f"(`{qual}`) outside PERSIST_SITES "
                    f"({reg_sf.short}) — persist bytes must flow "
                    "through the atomic-write/WAL helpers "
                    "(write-temp -> fsync -> rename), or a crash "
                    "mid-write corrupts the only copy",
                )
            for line in savez:
                yield Finding(
                    "DL017", sf.posix, line,
                    f"np.save*/torch.save to a PATH in persist scope (`{qual}`) "
                    "outside PERSIST_SITES — hand it the file object "
                    "an atomic writer opened instead",
                )
            for line in replaces:
                yield Finding(
                    "DL017", sf.posix, line,
                    f"os.replace/os.rename in persist scope "
                    f"(`{qual}`) outside PERSIST_SITES — renames into "
                    "the persist root belong to the reviewed atomic "
                    "writers",
                )
        # module-level statements (outside every function)
        module_probe = ast.Module(body=sf.tree.body, type_ignores=[])
        opens, replaces, _fsyncs, savez = _scan(module_probe)
        for line in opens:
            if line not in covered:
                yield Finding(
                    "DL017", sf.posix, line,
                    "bare write-mode open() at module level of a "
                    "persist scope — persist bytes must flow through "
                    "PERSIST_SITES",
                )
        for line in savez:
            if line not in covered:
                yield Finding(
                    "DL017", sf.posix, line,
                    "np.save*/torch.save to a PATH at module level of a persist "
                    "scope — persist bytes must flow through "
                    "PERSIST_SITES",
                )
        for line in replaces:
            if line not in covered:
                yield Finding(
                    "DL017", sf.posix, line,
                    "os.replace at module level of a persist scope — "
                    "renames belong to the reviewed atomic writers",
                )
    if not ctx.partial:
        line = _registry_line(reg_sf)
        for site in sorted(declared):
            if not used.get(site):
                yield Finding(
                    "DL017", reg_sf.posix, line,
                    f"PERSIST_SITES declares {site!r} but no such "
                    "function performs a persist write — stale entry "
                    "(the writer moved or was deleted; the discipline "
                    "would claim coverage it no longer has)",
                )


def _registry_line(reg_sf) -> int:
    for node in reg_sf.tree.body:
        if isinstance(node, ast.Assign) and any(
            getattr(t, "id", None) == "PERSIST_SITES" for t in node.targets
        ):
            return node.lineno
    return 1
