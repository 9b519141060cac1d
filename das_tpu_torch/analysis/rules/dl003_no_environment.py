"""DL003 — the port reads no environment.

Contract (ROADMAP conventions; core/config.py): `das_tpu` grew a
registry of `DAS_TPU_*` environment switches (its ENV_REGISTRY) after
module-local reads had drifted outside its config.  The port took the
other road: every switch is a `DasConfig` field or an argument — the
fault plan is armed only by `fault.configure(spec)`, the recorder only by
`obs.configure(...)`, the ledger only by `proflog.configure(...)` — so a
deployment's behavior is what its config says, and the chip machine's
environment cannot change an answer.  This rule pins that mechanically:

  * any reference to the process environment in the analyzed set
    fires: an `environ` / `environb` attribute or name (reads, writes,
    `.get`, `in`, copies), and the `getenv` / `putenv` / `unsetenv`
    functions, called or not.

A module that must see the environment (none does) would declare why in
the baseline.  tests/test_torch_imports.py pins the same per file with
its own scan, so the two guard each other.
"""

from __future__ import annotations

import ast
from typing import Iterable

from das_tpu_torch.analysis.core import AnalysisContext, Finding, register

#: names whose reference reaches the process environment
ENV_NAMES = frozenset(("environ", "environb", "getenv", "putenv", "unsetenv"))


@register("DL003", "no environment read in the port")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    for sf in ctx.modules():
        seen = set()
        for node in sf.nodes:
            name = None
            if isinstance(node, ast.Attribute) and node.attr in ENV_NAMES:
                name = node.attr
            elif isinstance(node, ast.Name) and node.id in ENV_NAMES:
                name = node.id
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                hit = [a.name for a in node.names if a.name in ENV_NAMES]
                name = hit[0] if hit else None
            if name is None or (node.lineno, name) in seen:
                continue
            seen.add((node.lineno, name))
            yield Finding(
                "DL003", sf.posix, node.lineno,
                f"environment access `{name}` — the port reads no "
                "environment: every switch is a DasConfig field or an "
                "argument, so the machine's environment cannot change "
                "what a deployment does",
            )
