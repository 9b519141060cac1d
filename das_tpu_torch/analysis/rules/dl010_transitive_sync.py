"""DL010 — transitive host sync on a dispatch path (DL001, call-graph
edition).

Contract: DL001 bans host synchronization inside the dispatch halves
SYNTACTICALLY — which a one-line refactor escapes: move the `.cpu()`
into a helper and the dispatch body is clean while every batch still
waits for the card at dispatch time, the depth-N pipeline silently
degrades to serial, and no functional test fails.  This rule runs the
same dispatch-root discovery as DL001 and then FOLLOWS repo-local calls
(analysis/callgraph.py): a dispatch root reaching `.item()` /
`.tolist()` / `.cpu()` / `.numpy()` / `.to("cpu")` / a `.synchronize()`
/ a blocking `.wait()` / a fetch helper (`fetch`, `fetch_many`,
`retried_fetch`) / `np.asarray` / `np.array` through ANY chain of
resolvable helpers fires, with the offending call path rendered in the
finding.

Scope notes:

  * depth >= 1 only — the root's own direct constructs are DL001's
    findings; reporting them twice would just double the baseline;
  * the builtin float()/int()/bool() coercions DL001 flags directly
    are NOT propagated: transitively, "some helper coerces an int"
    is almost always host arithmetic (capacity math, shape checks),
    and a rule that cries wolf gets suppressed;
  * a kernel wrapper's plain branch is not followed: the wrappers
    (`kernels/`) take their plain PyTorch version only for CPU tensors
    (`launch.is_cuda`), where a `.tolist()` waits for nothing, and the
    card's branch is DL011's to keep sort- and sync-free;
  * resolution under-approximates (parameters holding callables and
    unknown attribute chains don't resolve — see callgraph.py), so a
    clean verdict is "no REACHABLE sync", not a proof.  What it does
    report is a real dispatch->transfer path.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from das_tpu_torch.analysis.callgraph import callgraph
from das_tpu_torch.analysis.core import AnalysisContext, Finding, attr_chain, register
from das_tpu_torch.analysis.rules.dl001_host_sync import dispatch_functions, transfer

_NUMPY_CALLS = frozenset((
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
))


def _direct_syncs(fn: ast.AST) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        what = transfer(node)
        if what is None and attr_chain(node.func) in _NUMPY_CALLS:
            what = f"{attr_chain(node.func)}()"
        if what is not None:
            out.append((node.lineno, what))
    return out


def _render_path(root: str, path) -> str:
    """`dispatch -> helper_a -> helper_b` with the short name of each
    hop (qnames carry full modules; the file is in the finding head)."""
    hops = [root] + [q.split("::", 1)[1] for _line, q in path]
    return " -> ".join(hops)


def _in_kernels(info) -> bool:
    return "kernels" in info.sf.path.parts[:-1]


@register("DL010", "transitive host sync on a dispatch path")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    graph = callgraph(ctx)
    for sf in ctx.modules():
        for qname, fn in dispatch_functions(sf.tree):
            cls = qname.split(".")[0] if "." in qname else None
            for info, path in graph.walk(sf, fn, cls, stop=_in_kernels):
                # one finding per construct and function, named without
                # its line: a baseline entry must survive edits around it
                for what in dict.fromkeys(w for _l, w in _direct_syncs(info.node)):
                    yield Finding(
                        "DL010", sf.posix, path[0][0],
                        f"dispatch path `{qname}` reaches {what} in "
                        f"{info.sf.short} `{info.qname.split('::', 1)[1]}` via "
                        f"`{_render_path(qname, path)}` — dispatch must "
                        "stay transfer-free through every helper; host "
                        "synchronization belongs in the settle half",
                    )
