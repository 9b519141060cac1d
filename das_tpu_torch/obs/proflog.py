"""The program ledger (port of `das_tpu/obs/proflog.py`).

`das_tpu` compiles whole-plan XLA programs and keeps, per plan signature,
what the compiler did: the first compile's wall time, its cost and memory
analysis, and the budget planner's modeled bytes beside the compiler's
allocation.  The port compiles no programs: a plan runs as eager launches
of the hand-written kernels.  So each column gets the counterpart that
means the same thing on the card:

  * an instrumented "program" is one of the port's builders (`run_conj` of
    a fused round, a tree job's function, the exact program, a count
    group's round, the sharded round and tree); its entries are keyed by
    (site, digest of the plan signature), as in `das_tpu`, and by the
    shapes of the call's arguments;
  * the first call of a key is its "compile": `compile_s` is that call's
    wall time, taken between `torch.cuda.synchronize()` calls on the card;
    `peak_bytes` is the rise of `torch.cuda.max_memory_allocated` over
    `memory_allocated` across it (None on the CPU), `out_bytes` the
    outputs' bytes, `temp_bytes` the rest of the rise, `arg_bytes` the
    tensor arguments' bytes; later calls of the key are ledger hits;
  * `modeled_bytes` is kernels/budget.py's footprint of the same call
    (query/fused.py `program_model_bytes`), and `budget_vs_actual_ratio`
    is modeled over `peak_bytes`: how well the TPU-priced budget fits the
    card's allocation;
  * `flops` and `bytes_accessed` stay None: eager PyTorch has no compiler
    cost model;
  * cold start: the kernel library's `nvcc` build (kernels/launch.py) and
    the scanner's `g++` build (ingest/native.py) are the port's fresh
    compiles.  A fresh build adds its wall time to `cold_start_s`; a load
    of an already-built library counts as a `persistent_cache_hit`;
  * kernel launches (`record_launch`, from the five wrappers through
    kernels/launch.py) are noted per (kernel, shapes) with kind "cuda" for
    a kernel launch and "plain" for the CPU version, the counterparts of
    "pallas" and "discharge"; `trace_s` sums the wrapper's host time.

Off by default.  Only `configure(enabled=)` switches it (process-wide, like
`obs.configure` and `fault.configure`); no environment variable is read.
Off, `instrument(site, digest, fn)` returns `fn` itself, `launch_mark()`
returns 0.0 and `record_launch` / `record_build` return at once.  The
ledger never costs an answer: a failure of its own bookkeeping is recorded
as the entry's `error` and the call goes on; an error of the wrapped call
itself (a CUDA error included) propagates untouched.

`PROGRAM_SITES` maps every scope of das_tpu_torch/ that calls `instrument`,
`record_launch` or `record_build` to its site label (pinned by
tests/test_torch_proflog.py against the source); `PROGRAM_INNER_SITES`
the scopes that run a program only inside another site's (daslint
DL016)."""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

#: the scopes ("module.qualname", outermost function) that feed the ledger,
#: with the site label each passes
PROGRAM_SITES: Dict[str, str] = {
    "fused._ExecJob.dispatch": "fused",
    "fused._TreeExecJob._build": "fused_tree",
    "fused.FusedExecutor.execute_exact": "fused_exact",
    "fused.FusedExecutor._run_batch_group": "count_batch",
    "fused_sharded._ShardedExecJob.dispatch": "sharded",
    "fused_sharded._ShardedTreeExecJob._build": "sharded_tree",
    "launch.noted": "kernel",
    "launch.library": "kernel_build",
    "native.get_lib": "scanner_build",
}

#: the scopes that run a program function only INSIDE another site's
#: instrumented program, with that site's label (daslint DL016): the tree
#: builders' functions run inside the "fused_tree" / "sharded_tree"
#: programs, count_batch's lanes inside each "count_batch" round
PROGRAM_INNER_SITES: Dict[str, str] = {
    "fused.build_fused_tree": "fused_tree",
    "fused.FusedExecutor.count_batch": "count_batch",
    "fused_sharded.build_sharded_tree_fused": "sharded_tree",
}

#: ledger entry bound: past it the oldest entries drop (the recorder's ring)
_MAX_ENTRIES = 1024

#: who may mutate each ProgramLedger attribute after __init__ (daslint
#: DL006): every one only under `with self._lock:` — the serving worker,
#: RPC threads (coalescer_stats) and builders on any thread share the one
#: ledger
LOCK_DISCIPLINE = {
    "ProgramLedger.enabled": "_lock",
    "ProgramLedger.entries": "_lock",
    "ProgramLedger._keys": "_lock",
    "ProgramLedger.compiles": "_lock",
    "ProgramLedger.compile_s": "_lock",
    "ProgramLedger.cold_start_s": "_lock",
    "ProgramLedger.persistent_cache_hits": "_lock",
    "ProgramLedger.calls": "_lock",
    "ProgramLedger.hits": "_lock",
    "ProgramLedger.errors": "_lock",
    "ProgramLedger.launches": "_lock",
}


def sig_digest(*parts) -> str:
    """Digest of a plan signature and its variant discriminators (the
    frozen signature dataclasses have deterministic reprs), 16 hex chars,
    as in das_tpu."""
    return hashlib.md5(repr(parts).encode()).hexdigest()[:16]


def _tensors(obj, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    return out


def _shape_key(obj) -> Tuple:
    """The shapes and dtypes of a call's arguments (tensors and numpy
    arrays), nested as the arguments are; other values by type."""
    if isinstance(obj, (list, tuple)):
        return tuple(_shape_key(x) for x in obj)
    shape = getattr(obj, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(obj, "dtype", "")))
    return ("py", type(obj).__name__)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ProgramLedger:
    """Bounded map of (site, digest) -> one program's record, plus the
    totals `coalescer_stats()["programs"]` shows."""

    def __init__(self):
        self.enabled = False
        self.capacity = _MAX_ENTRIES
        self._lock = threading.RLock()
        self.reset()

    # -- configuration ---------------------------------------------------

    def configure(self, enabled: Optional[bool] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)

    def reset(self) -> None:
        with self._lock:
            self.entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
            #: per entry, the argument-shape keys already called
            self._keys: Dict[Tuple[str, str], set] = {}
            self.compiles = 0
            self.compile_s = 0.0
            self.cold_start_s = 0.0
            self.persistent_cache_hits = 0
            self.calls = 0
            self.hits = 0
            self.errors = 0
            self.launches = 0

    # -- recording --------------------------------------------------------

    def _entry(self, site: str, digest: str, kind: str) -> Dict[str, Any]:
        with self._lock:
            key = (site, digest)
            e = self.entries.get(key)
            if e is not None:
                return e
            if len(self.entries) >= self.capacity:
                old = next(iter(self.entries))
                self.entries.pop(old)
                self._keys.pop(old, None)
            e = {
                "site": site, "digest": digest, "kind": kind,
                "compiles": 0, "compile_s": 0.0, "first_compile_s": None,
                "persistent_cache_hit": False,
                "flops": None, "bytes_accessed": None,
                "arg_bytes": None, "out_bytes": None, "temp_bytes": None, "peak_bytes": None,
                "modeled_bytes": None, "budget_vs_actual_ratio": None,
                "calls": 0, "hits": 0, "launches": 0, "trace_s": 0.0, "error": None,
            }
            self.entries[key] = e
            return e

    def first_call(self, site: str, digest: str, key: Tuple) -> bool:
        """Whether `key` is new for the entry (then it is marked seen)."""
        with self._lock:
            self._entry(site, digest, "eager")
            seen = self._keys.setdefault((site, digest), set())
            if key in seen:
                return False
            seen.add(key)
            return True

    def record_compile(self, site: str, digest: str, wall_s: float, arg_bytes: int,
                       out_bytes: int, peak_bytes: Optional[int],
                       modeled_bytes: Optional[int]) -> None:
        with self._lock:
            e = self._entry(site, digest, "eager")
            e["compiles"] += 1
            e["compile_s"] += wall_s
            if e["first_compile_s"] is None:
                e["first_compile_s"] = wall_s
            e["arg_bytes"], e["out_bytes"], e["peak_bytes"] = arg_bytes, out_bytes, peak_bytes
            e["temp_bytes"] = None if peak_bytes is None else max(0, peak_bytes - out_bytes)
            if modeled_bytes:
                e["modeled_bytes"] = int(modeled_bytes)
                if peak_bytes:
                    e["budget_vs_actual_ratio"] = round(int(modeled_bytes) / peak_bytes, 4)
            e["calls"] += 1
            self.compiles += 1
            self.compile_s += wall_s
            self.calls += 1
        from das_tpu_torch import obs

        obs.counter("prof.compiles").inc()
        obs.histogram("prof.compile_ms").observe(wall_s * 1e3)
        # the compile lane: with tracing on too, each first call lands as a
        # span of its own lane, its duration the wall time above
        obs.REC.record("prof.compile", "X", time.perf_counter() - wall_s, wall_s, 0,
                       {"site": site, "digest": digest, "persistent_cache_hit": False},
                       lane="compile")

    def record_build(self, site: str, digest: str, wall_s: float, fresh: bool) -> None:
        """One kernel-library or scanner build (fresh) or load of an
        already-built library (a persistent-cache hit)."""
        with self._lock:
            e = self._entry(site, digest, "build")
            e["compiles"] += 1
            e["compile_s"] += wall_s
            if e["first_compile_s"] is None:
                e["first_compile_s"] = wall_s
            e["persistent_cache_hit"] = not fresh
            if fresh:
                self.cold_start_s += wall_s
            else:
                self.persistent_cache_hits += 1

    def record_error(self, site: str, digest: str, err: BaseException) -> None:
        with self._lock:
            e = self._entry(site, digest, "eager")
            e["error"] = repr(err)[:200]
            self.errors += 1

    def record_hit(self, site: str, digest: str) -> None:
        """A later call of a key already called (a ledger hit)."""
        with self._lock:
            e = self._entry(site, digest, "eager")
            e["calls"] += 1
            e["hits"] += 1
            self.calls += 1
            self.hits += 1

    def record_launch(self, site: str, digest: str, kind: str, wall_s: float) -> None:
        with self._lock:
            e = self._entry(site, digest, kind)
            e["launches"] += 1
            e["trace_s"] += wall_s
            self.launches += 1

    # -- readout ----------------------------------------------------------

    def rows(self, site: Optional[str] = None,
             digest: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self.entries.values()
                    if (site is None or e["site"] == site)
                    and (digest is None or e["digest"] == digest)]

    def snapshot(self) -> Dict[str, Any]:
        """The coalescer_stats()["programs"] surface: first calls and their
        seconds, the ledger hit rate, the cold start, and the mean
        budget-vs-actual ratio per site."""
        with self._lock:
            ratios: Dict[str, List[float]] = {}
            for e in self.entries.values():
                r = e["budget_vs_actual_ratio"]
                if r is not None:
                    ratios.setdefault(e["site"], []).append(r)
            return {
                "enabled": self.enabled,
                "compiles": self.compiles,
                "compile_s": round(self.compile_s, 4),
                "calls": self.calls,
                "ledger_hits": self.hits,
                "hit_rate": round(self.hits / self.calls, 4) if self.calls else None,
                "cold_start_s": round(self.cold_start_s, 4),
                "persistent_cache_hits": self.persistent_cache_hits,
                "errors": self.errors,
                "launches": self.launches,
                "entries": len(self.entries),
                "budget_vs_actual": {site: round(sum(rs) / len(rs), 4)
                                     for site, rs in sorted(ratios.items())},
            }


#: the process ledger, off until configured
LEDGER = ProgramLedger()


def enabled() -> bool:
    return LEDGER.enabled


def configure(enabled: Optional[bool] = None) -> None:
    LEDGER.configure(enabled=enabled)


def reset() -> None:
    LEDGER.reset()


def snapshot() -> Dict[str, Any]:
    return LEDGER.snapshot()


def rows(site: Optional[str] = None, digest: Optional[str] = None) -> List[Dict[str, Any]]:
    return LEDGER.rows(site=site, digest=digest)


def compile_totals() -> Tuple[int, float]:
    """(first calls, their seconds): the basis of compile_delta."""
    return LEDGER.compiles, LEDGER.compile_s


def compile_delta(before: Tuple[int, float]) -> Dict[str, Any]:
    """Programs first called and their seconds since `before`
    (compile_totals() at the start of a section)."""
    c0, s0 = before
    return {"programs_compiled": LEDGER.compiles - c0,
            "compile_s": round(LEDGER.compile_s - s0, 3)}


class _InstrumentedProgram:
    """One instrumented builder: the first call of each argument-shape key
    is timed and measured, later ones count as hits."""

    __slots__ = ("site", "digest", "fn", "model_bytes")

    def __init__(self, site: str, digest: str, fn, model_bytes: Optional[Callable] = None):
        self.site = site
        self.digest = digest
        self.fn = fn
        self.model_bytes = model_bytes

    def __call__(self, *args):
        led = LEDGER
        if not led.enabled:
            return self.fn(*args)
        try:
            inputs = _tensors(args, [])
            first = led.first_call(self.site, self.digest, _shape_key(args))
        except Exception as err:   # the ledger's own failure never costs an answer
            led.record_error(self.site, self.digest, err)
            return self.fn(*args)
        if not first:
            led.record_hit(self.site, self.digest)
            return self.fn(*args)
        dev = next((t.device for t in inputs if t.is_cuda), None)
        if dev is not None:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = self.fn(*args)
        if dev is not None:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        try:
            peak = None
            if dev is not None:
                peak = max(0, torch.cuda.max_memory_allocated(dev) - base)
            modeled = None
            if self.model_bytes is not None:
                try:
                    modeled = self.model_bytes(*args)
                except Exception:
                    modeled = None
            led.record_compile(self.site, self.digest, wall, _nbytes(inputs),
                               _nbytes(_tensors(out, [])), peak, modeled)
        except Exception as err:
            led.record_error(self.site, self.digest, err)
        return out


def instrument(site: str, digest: str, fn, model_bytes: Optional[Callable] = None):
    """Route one builder's function through the ledger.  Off (the
    default): returns `fn` itself, so the path is the plain one.  On: the
    recording wrapper.  `site` is a PROGRAM_SITES label."""
    if not LEDGER.enabled:
        return fn
    return _InstrumentedProgram(site, digest, fn, model_bytes)


def launch_mark() -> float:
    """perf_counter origin for a record_launch note; 0.0 when the ledger
    is off, so the off path pays one attribute read and no clock call."""
    if not LEDGER.enabled:
        return 0.0
    return time.perf_counter()


def record_launch(site: str, kernel: str, shapes, t0: float, cuda: bool) -> None:
    """Note one kernel wrapper call: kind "cuda" where it launched its
    kernel, "plain" where it ran the CPU version; the wall time is the
    wrapper's host time since `t0` (launch_mark).  No-op when off."""
    if not LEDGER.enabled or not t0:
        return
    wall = time.perf_counter() - t0
    LEDGER.record_launch(site, sig_digest(kernel, shapes), "cuda" if cuda else "plain", wall)


def record_build(site: str, digest: str, wall_s: float, fresh: bool) -> None:
    """Note one library build (fresh) or load of a built one.  No-op when
    off."""
    if LEDGER.enabled:
        LEDGER.record_build(site, digest, wall_s, fresh)
