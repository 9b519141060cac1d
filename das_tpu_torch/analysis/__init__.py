"""daslint for das_tpu_torch — an AST invariant analyzer of the port's
contracts (the port of `das_tpu/analysis/`, same CLI, same rule IDs).

The port carries the contracts `das_tpu`'s analyzer checks — dispatch
halves that never wait for the card, frozen plan signatures that key
every cache, closed registries of route keys, fetch sites, collectives,
fault seams, spans and program sites, lock-disciplined threaded state,
atomic persist writes — and one stray `.cpu()` in a dispatch half or a
counter key nobody declared fails no functional test.  Each rule is
written for the port's idioms: `.item()` / `.cpu()` / `.numpy()` /
`torch.cuda.synchronize` / `_Staged.wait()` / the fetch helpers where
`das_tpu` had `jax.device_get`; `torch.distributed` and the mesh helpers
where it had XLA collectives; the CUDA sources under `kernels/csrc/`,
read as text, where it had Pallas bodies.

Usage:  python -m das_tpu_torch.analysis [paths...]
        (--select/--ignore for subsets, --format json|sarif)

Rules (one module each under rules/):

  DL001 host-sync-in-dispatch   dispatch halves are transfer-free
  DL002 plan-sig completeness   routing fields live in the frozen sig
  DL003 no environment          the port reads no environment variable
  DL004 counter discipline      ROUTE keys <-> ops/counters.py
  DL005 shared-memory drift     __shared__ / dynamic smem <->
                                kernels/shared_memory.py KERNEL_SHARED
  DL006 lock discipline         threaded state <-> LOCK_DISCIPLINE
  DL007 cache-insert guard      delta_version captured before dispatch
  DL008 planner vocabularies    routes/counter keys <-> ops/counters.py
  DL009 collective discipline   mesh collectives <-> COLLECTIVE_SITES,
                                torch.distributed <-> COLLECTIVE_HELPERS
  DL010 transitive host sync    DL001 through the whole call graph
  DL011 kernel-entry contract   entries bound, launches counted, no
                                fallback, no sort on the card's branch
  DL012 cache keying            cached programs and libraries keyed by
                                their *Sig / source digest
  DL013 fetch-site registry     host transfers <-> FETCH_SITES + tally
  DL014 obs name discipline     span/metric names <-> obs/registry.py
  DL015 fault-site registry     maybe_fail <-> FAULT_SITES, ban in
                                kernels/ and dispatch halves
  DL016 program-site registry   program functions / library loads <->
                                PROGRAM_SITES + the ledger hooks
  DL017 durability discipline   persist writes via atomic helpers,
                                fsync-before-rename, PERSIST_SITES

Per-file suppression: a comment line `# daslint: disable=DL001[,DL002]`
(`// daslint: disable=DL005` in a CUDA source) anywhere in a file
disables those rules for that file.  Deliberate keeps are grandfathered
in `baseline.json` beside this file with a one-line justification; stale
baseline entries fail the run so the file cannot rot.  Everything here
is stdlib-`ast` only and imports nothing of `das_tpu` and no `jax` — the
analyzer never imports the modules it checks.
"""

from das_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    iter_rules,
    load_baseline,
    run_analysis,
)
