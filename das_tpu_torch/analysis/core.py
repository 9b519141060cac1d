"""daslint infrastructure: findings, checker registry, suppressions,
baseline, and the entry point that runs every rule over a parsed file set.

Rules are whole-set checkers, not per-file visitors: several contracts
are cross-file (a counter literal in api/atomspace.py against
ops/counters.py; a `__shared__` buffer in kernels/csrc/*.cu against the
manifest in kernels/shared_memory.py), so each rule receives the
complete AnalysisContext and yields findings wherever it likes.
Registration is import-time (`@register` in each rules/ module);
das_tpu_torch.analysis.rules imports them all.

Besides the Python modules the context carries the CUDA sources
(`*.cu` / `*.cuh`) found under the analyzed paths, as text: DL005 and
DL011 read them, and nothing compiles or imports them.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: per-FILE suppression — a comment reading
#: "daslint: disable=DL001,DL002" after its leading hash(es) (after `//`
#: in a CUDA source); the whole
#: file opts out of those rules (deliberately no line-level variant: a
#: file either honors a contract or documents why not).  Anchored to
#: real COMMENT tokens (tokenize), so quoting the syntax in a docstring
#: or a string literal does not silently disable anything.
_SUPPRESS_RE = re.compile(r"daslint:\s*disable=([A-Za-z0-9_,\s-]+)")


def _parse_suppressions(text: str) -> frozenset:
    disabled = set()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type != tokenize.COMMENT:
            continue
        body = tok.string.lstrip("#").strip()
        m = _SUPPRESS_RE.match(body)
        if m:
            disabled.update(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
    return frozenset(disabled)


@dataclass(frozen=True)
class Finding:
    rule: str      # "DL001"
    path: str      # path as analyzed (posix)
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> Dict:
        return {
            "rule": self.rule, "path": self.path,
            "line": self.line, "message": self.message,
        }


_CUDA_SUPPRESS_RE = re.compile(r"^\s*//\s*daslint:\s*disable=([A-Za-z0-9_,\s-]+)$", re.M)


class SourceFile:
    """One parsed module: text, AST, and its per-file rule suppressions."""

    def __init__(self, path: Path, text: str):
        self.path = path
        self.posix = path.as_posix()
        #: invocation-stable display form (last two components) for use
        #: INSIDE finding messages: baseline entries match messages
        #: exactly, so a message must not change between a relative
        #: `das_tpu_torch` run and an absolute-path run
        self.short = "/".join(path.parts[-2:])
        self.name = path.stem
        self.text = text
        self.tree = ast.parse(text, filename=str(path))
        self.disabled = _parse_suppressions(text)
        self._nodes: Optional[List[ast.AST]] = None
        self._names: Optional[frozenset] = None

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the module (`ast.walk` order), walked once: the
        rules scan whole modules many times over."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    @property
    def names(self) -> frozenset:
        """Every identifier the module mentions (names, attributes,
        function names): a rule skips a module that cannot hold its
        construct before walking it."""
        if self._names is None:
            out = set()
            for node in self.nodes:
                if isinstance(node, ast.Name):
                    out.add(node.id)
                elif isinstance(node, ast.Attribute):
                    out.add(node.attr)
            self._names = frozenset(out)
        return self._names


class CudaFile:
    """One CUDA source (`.cu` / `.cuh`), read as text: the analyzer never
    compiles it.  `// daslint: disable=DL005` on a line of its own
    suppresses rules for the file, as the comment does in a module."""

    def __init__(self, path: Path, text: str):
        self.path = path
        self.posix = path.as_posix()
        self.short = "/".join(path.parts[-2:])
        self.name = path.name
        self.text = text
        disabled = set()
        for m in _CUDA_SUPPRESS_RE.finditer(text):
            disabled.update(r.strip() for r in m.group(1).split(",") if r.strip())
        self.disabled = frozenset(disabled)


class AnalysisContext:
    """The whole analyzed file set plus the tests directory (DL004's
    "every counter key is referenced by at least one test" leg).

    `partial` marks a deliberately incomplete file set (the CLI's
    --allow-partial): registry-completeness legs — stale COLLECTIVE_SITES/
    FETCH_SITES/KERNEL_SHARED entries, declared-but-uncounted keys — are
    skipped, because an entry whose
    owner simply isn't in the set would fire falsely.  Presence legs
    (an undeclared call/read/key in an analyzed file) still run; the
    full-set run remains the authority on staleness."""

    def __init__(self, files: List[SourceFile], tests_dir: Optional[Path],
                 partial: bool = False, cuda_files: Sequence["CudaFile"] = ()):
        self.files = files
        self.tests_dir = tests_dir
        self.partial = partial
        self.cuda_files = list(cuda_files)

    def modules(self) -> Iterable[SourceFile]:
        return self.files


RuleFunc = Callable[[AnalysisContext], Iterable[Finding]]

_REGISTRY: Dict[str, Tuple[RuleFunc, str]] = {}


def register(rule_id: str, title: str):
    """Register a rule checker.  rule_id is the stable DLxxx name used in
    suppressions and the baseline file."""

    def deco(fn: RuleFunc) -> RuleFunc:
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate daslint rule {rule_id}")
        _REGISTRY[rule_id] = (fn, title)
        return fn

    return deco


def iter_rules() -> List[Tuple[str, str]]:
    _load_rules()
    return sorted((rid, title) for rid, (_fn, title) in _REGISTRY.items())


def _load_rules() -> None:
    # import-time registration; idempotent
    import das_tpu_torch.analysis.rules  # noqa: F401


_CUDA_SUFFIXES = (".cu", ".cuh")

#: per-process parse/summary cache keyed by (path, mtime_ns, size): the
#: tier-1 suite calls run_analysis dozens of times (fixture corpus,
#: mutated-copy regressions, the whole-tree pin) and re-parsing ~160
#: modules each time would dominate as the rule count grows.  The AST
#: and everything lazily hung off the SourceFile (per-module symbol
#: tables, callgraph.ModuleTable) ride along; an edited file re-parses
#: because its mtime_ns/size stamp moves.
_FILE_CACHE: Dict[str, Tuple[Tuple[int, int], SourceFile]] = {}


def _load_source(path: Path):
    key = path.as_posix()
    st = path.stat()
    stamp = (st.st_mtime_ns, st.st_size)
    hit = _FILE_CACHE.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    cls = CudaFile if path.suffix in _CUDA_SUFFIXES else SourceFile
    sf = cls(path, path.read_text())
    _FILE_CACHE[key] = (stamp, sf)
    return sf


def _collect(paths: Sequence[Path]) -> list:
    """Every module and CUDA source under `paths` (directories walked,
    sorted, no __pycache__), loaded through the parse cache.  A file
    given by name is a CUDA source when its suffix says so, else a
    module."""
    out = []
    seen = set()
    for p in paths:
        p = Path(p)
        if p.is_dir():
            candidates = sorted(
                c for c in p.rglob("*")
                if c.suffix in (".py",) + _CUDA_SUFFIXES and c.is_file()
            )
        else:
            candidates = [p]
        for c in candidates:
            if "__pycache__" in c.parts or c in seen:
                continue
            seen.add(c)
            out.append(_load_source(c))
    return out


def collect_files(paths: Sequence[Path]) -> List[SourceFile]:
    """Expand files/directories into parsed SourceFiles (sorted, no
    __pycache__), through the (path, mtime, size) parse cache.  A syntax
    error is surfaced as the caller's problem — the analyzer refuses to
    half-check a tree it cannot parse."""
    return [f for f in _collect(paths) if isinstance(f, SourceFile)]


def run_analysis(
    paths: Sequence[Path],
    *,
    rules: Optional[Sequence[str]] = None,
    tests_dir: Optional[Path] = None,
    partial: bool = False,
) -> List[Finding]:
    """Run (a subset of) the registered rules over `paths` and return the
    findings that survive per-file suppressions, sorted for stable
    output.  Baseline filtering is the caller's second step
    (apply_baseline) so tests can inspect raw findings.  `partial`
    relaxes the registry-completeness legs for deliberately incomplete
    file sets (see AnalysisContext)."""
    _load_rules()
    loaded = _collect(paths)
    ctx = AnalysisContext(
        [f for f in loaded if isinstance(f, SourceFile)], tests_dir, partial,
        [f for f in loaded if isinstance(f, CudaFile)],
    )
    # an EMPTY subset (e.g. --select X --ignore X) runs nothing — only
    # None means "all rules"
    wanted = set(rules) if rules is not None else set(_REGISTRY)
    unknown = wanted - set(_REGISTRY)
    if unknown:
        raise ValueError(f"unknown daslint rule(s): {sorted(unknown)}")
    suppressed = {f.posix: f.disabled for f in loaded}
    findings: List[Finding] = []
    for rid in sorted(wanted):
        fn, _title = _REGISTRY[rid]
        for finding in fn(ctx):
            if finding.rule in suppressed.get(finding.path, ()):
                continue
            findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


# -- baseline ---------------------------------------------------------------
#
# daslint.baseline.json grandfathers findings we deliberately keep.  An
# entry matches by (rule, path SUFFIX, exact message) — no line numbers,
# so unrelated edits above a kept finding don't churn the file.  Every
# entry must carry a one-line justification, and entries that no longer
# match anything are STALE and fail the run: the baseline records debt,
# it must not outlive it.


@dataclass
class BaselineEntry:
    rule: str
    path: str
    message: str
    justification: str
    matched: bool = field(default=False, compare=False)

    def matches(self, f: Finding) -> bool:
        return (
            f.rule == self.rule
            and f.message == self.message
            and (f.path == self.path or f.path.endswith("/" + self.path))
        )


def load_baseline(path: Path) -> List[BaselineEntry]:
    data = json.loads(Path(path).read_text())
    entries = []
    for raw in data.get("findings", []):
        if not raw.get("justification"):
            raise ValueError(
                f"baseline entry without justification: {raw!r}"
            )
        entries.append(BaselineEntry(
            rule=raw["rule"], path=raw["path"], message=raw["message"],
            justification=raw["justification"],
        ))
    return entries


def apply_baseline(
    findings: List[Finding], baseline: List[BaselineEntry]
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Partition into (new, grandfathered) and return stale entries."""
    new: List[Finding] = []
    kept: List[Finding] = []
    for f in findings:
        entry = next((b for b in baseline if b.matches(f)), None)
        if entry is None:
            new.append(f)
        else:
            entry.matched = True
            kept.append(f)
    stale = [b for b in baseline if not b.matched]
    return new, kept, stale


# -- shared AST helpers (used by several rules) -----------------------------


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_assign(tree: ast.Module, name: str) -> Optional[ast.AST]:
    """The value of a module-level `name = ...` assignment, or None."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
        elif isinstance(node, ast.AnnAssign):
            if (
                isinstance(node.target, ast.Name)
                and node.target.id == name
            ):
                return node.value
    return None


def str_collection(node: Optional[ast.AST]) -> Optional[Tuple[str, ...]]:
    """A tuple/list/set literal of string constants, else None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = [const_str(e) for e in node.elts]
        if all(v is not None for v in vals):
            return tuple(vals)  # type: ignore[arg-type]
    return None


def attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted-name string for Name/Attribute chains ("os.environ.get")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
