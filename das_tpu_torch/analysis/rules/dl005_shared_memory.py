"""DL005 — shared-memory model drift of the CUDA kernels.

Contract (kernels/csrc/, kernels/shared_memory.py): `das_tpu` pinned
the VMEM buffers of every Pallas body against the byte models that
route its stages.  The port's kernels are CUDA: each one's shared memory
is its static `__shared__` buffers plus the dynamic size its launch
passes (`<<<grid, block, smem, stream>>>`), which a plan function in C
prices from the shapes (jt_plan, mw_plan, ij_plan, grp_plan, the anti
join's set bits) and checks against the card's limit before it picks a
regime.  A shared buffer added to a kernel without its byte model is a
launch that fails on the card at sizes the plan accepted — or, worse,
a dynamic buffer carved past the bytes the launch asked for, which
reads and writes other data silently.  Off the card the plain versions
run instead, so the bug is invisible to every CPU test and must be
caught statically.

Mechanism: `KERNEL_SHARED` (kernels/shared_memory.py) declares, per
`__global__` kernel ("<source>:<kernel>"), the ordered tuple of its
`__shared__` declarations and the dynamic size of each launch that
gives one.  This rule reads every `.cu` / `.cuh` source in the analyzed
set as text (analysis/cuda.py) and pins sources <-> manifest both ways:

  * a kernel absent from the manifest, or whose tuple differs, names
    what changed (unaccounted / stale): update the plan function's byte
    model AND the entry in the same commit;
  * a kernel that declares an `extern __shared__` buffer but has no
    launch giving it dynamic shared memory reads memory it never got;
  * a `__shared__` declaration outside every kernel body cannot be
    attributed to a launch;
  * a manifest entry with no matching kernel is stale (full-set runs).

Like its original this is a tripwire, not a bytes proof: it cannot
check the plan function's arithmetic, but it guarantees every change of
a kernel's shared memory lands where that arithmetic lives, under
review.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from das_tpu_torch.analysis.core import (
    AnalysisContext,
    Finding,
    const_str,
    module_assign,
    register,
)
from das_tpu_torch.analysis.cuda import model


def _find_manifest(ctx: AnalysisContext):
    for sf in ctx.modules():
        node = module_assign(sf.tree, "KERNEL_SHARED")
        if isinstance(node, ast.Dict):
            manifest: Dict[str, Tuple[str, ...]] = {}
            for k, v in zip(node.keys, node.values):
                name = const_str(k) if k is not None else None
                if name is None:
                    continue
                entries = []
                if isinstance(v, (ast.Tuple, ast.List)):
                    entries = [const_str(e) for e in v.elts]
                manifest[name] = tuple(" ".join(e.split()) for e in entries if e is not None)
            return sf, node.lineno, manifest
    return None


def _kernel_shapes(ctx: AnalysisContext) -> List[Tuple[object, str, int, Tuple[str, ...], bool]]:
    """(file, key, line, declared tuple, has an extern buffer) per kernel."""
    out = []
    for cf in ctx.cuda_files:
        m = model(cf)
        for k in m.kernels:
            dynamic = sorted({
                la.dynamic_smem for la in m.launches
                if la.kernel == k.name and la.dynamic_smem is not None
            })
            shape = tuple(d for _l, d in k.shared) + tuple(f"dynamic: {d}" for d in dynamic)
            has_extern = any(d.startswith("extern ") for _l, d in k.shared)
            out.append((cf, f"{cf.name}:{k.name}", k.line, shape, has_extern and not dynamic))
    return out


@register("DL005", "kernel shared memory vs kernels.KERNEL_SHARED")
def check(ctx: AnalysisContext) -> Iterable[Finding]:
    for cf in ctx.cuda_files:
        for line, decl in model(cf).stray_shared:
            yield Finding(
                "DL005", cf.posix, line,
                f"__shared__ `{decl}` outside every __global__ kernel — "
                "shared memory must belong to a kernel whose launch and "
                "KERNEL_SHARED entry account for it",
            )
    kernels = _kernel_shapes(ctx)
    for cf, key, line, _shape, unfed in kernels:
        if unfed:
            yield Finding(
                "DL005", cf.posix, line,
                f"kernel `{key}` declares an extern __shared__ buffer but "
                "no launch gives it dynamic shared memory — it would read "
                "and write bytes it never got",
            )
    found = _find_manifest(ctx)
    if found is None:
        for cf, key, line, shape, _u in kernels:
            yield Finding(
                "DL005", cf.posix, line,
                f"kernel `{key}` but no KERNEL_SHARED manifest in the "
                "analyzed set (kernels/shared_memory.py declares the "
                "shared memory each kernel's plan prices)",
            )
        return
    man_sf, man_line, manifest = found
    seen = set()
    for cf, key, line, shape, _u in kernels:
        seen.add(key)
        if key not in manifest:
            yield Finding(
                "DL005", cf.posix, line,
                f"kernel `{key}` is not in KERNEL_SHARED — its shared "
                "memory is priced by no declared model; add the entry AND "
                "account for it in the kernel's plan function",
            )
            continue
        if manifest[key] != shape:
            extra = [d for d in shape if d not in manifest[key]]
            missing = [d for d in manifest[key] if d not in shape]
            yield Finding(
                "DL005", cf.posix, line,
                f"kernel `{key}` shared memory drifted from "
                f"KERNEL_SHARED: unaccounted={extra} stale={missing} — "
                "update the plan function's byte model and the manifest "
                "together",
            )
    # stale entries are only provable against the FULL set
    for key in manifest if not ctx.partial and ctx.cuda_files else ():
        if key not in seen:
            yield Finding(
                "DL005", man_sf.posix, man_line,
                f"KERNEL_SHARED entry `{key}` matches no kernel in the "
                "analyzed sources — stale manifest entry",
            )
