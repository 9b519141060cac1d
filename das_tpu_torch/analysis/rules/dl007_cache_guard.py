"""DL007 — delta_version guard on result-cache inserts.

Contract (query/fused.py ResultCache): every `ResultCache` insert must be
guarded by the delta version its result was DISPATCHED against —
`cache.put(key, result, version)` where `version` was captured via
`cache.version()` BEFORE the device dispatch.  `ResultCache.put`
re-checks that version under its lock, so a commit landing between
dispatch and settle can never smuggle a pre-commit answer in under the
post-commit version.

The asynchronous serving path is exactly what makes this worth
enforcing mechanically: speculative dispatch and streaming early-settle
WIDEN the dispatch→insert window — a group may settle (and insert) many
window slots after it dispatched, with arbitrary commits in between —
and they added new insert sites (`settle_pending_iter`).  The two bug
shapes a new site can take:

  * no version argument at all — the insert lands unconditionally, so a
    racing commit's invalidation is silently undone;
  * the version computed AT INSERT TIME (`cache.put(k, r,
    cache.version())`) — reads the POST-commit version for a PRE-commit
    answer, which defeats the guard while looking guarded.

Mechanism: every call `X.put(...)` whose receiver's terminal name is
one of the result-cache spellings below must pass a version (third
positional or `version=`) that is a pre-captured Name or Attribute
(`version`, `pending.version`, `self.version`, `cache_version`) — any
Call expression there (or a missing argument) is a finding.  This is a
shape check, not a dataflow proof: it forces every insert through the
capture-then-pass idiom the existing sites use, where review can see
WHEN the version was read.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from das_tpu_torch.analysis.core import AnalysisContext, Finding, register

#: receiver spellings that denote a delta-versioned ResultCache
#: (query/fused.py ResultCache and its executor/tree aliases).  A new
#: cache attribute name must be added here to stay covered — and the
#: rule's bad case (tests/test_torch_lint.py) pins that it fires.
RESULT_CACHE_NAMES = (
    "results",
    "tree_results",
    "results_cache",
    "result_cache",
    "cache",
)


def _receiver_name(node: ast.AST) -> Optional[str]:
    """Terminal attribute/name of a receiver chain: `self.results` ->
    "results", `results_cache` -> "results_cache"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


@register("DL007", "delta_version guard on result-cache inserts")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    for sf in ctx.modules():
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "put"):
                continue
            if _receiver_name(fn.value) not in RESULT_CACHE_NAMES:
                continue
            version: Optional[ast.AST] = None
            if len(node.args) >= 3:
                version = node.args[2]
            else:
                for kw in node.keywords:
                    if kw.arg == "version":
                        version = kw.value
            if version is None:
                yield Finding(
                    "DL007", sf.posix, node.lineno,
                    "result-cache insert without a dispatch-time version "
                    "— `.put(key, result, version)` must re-check the "
                    "delta version captured BEFORE dispatch, or a commit "
                    "racing dispatch→settle poisons the cache",
                )
            elif not isinstance(version, (ast.Name, ast.Attribute)):
                yield Finding(
                    "DL007", sf.posix, node.lineno,
                    "result-cache insert computes its version AT INSERT "
                    "TIME — that reads the post-commit version for a "
                    "pre-commit answer, defeating the delta_version "
                    "guard; capture `cache.version()` before dispatch "
                    "and pass that name through",
                )
