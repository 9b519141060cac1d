"""daslint for das_tpu_torch (`python -m das_tpu_torch.analysis`).

Pins, in order of load-bearing-ness:
  * the analyzer runs CLEAN over das_tpu_torch/ under its own baseline
    (das_tpu_torch/analysis/baseline.json), every entry justified;
  * each of DL001-DL017 FIRES on its bad case and stays quiet on its good
    case (the fixtures are strings here, written to tmp_path), through
    run_analysis and through the CLI's exit code;
  * the historical bug classes re-introduced on copies of the port's REAL
    source are caught: a dropped *Sig field routing reads (DL002), a
    `.cpu()` moved into a helper `_ExecJob.dispatch` calls (DL010), a
    count into an undeclared route key (DL004), a bare `open(path, "wb")`
    in a persist module (DL017);
  * the CLI contract: exit codes, the suppression comment, a stale
    baseline entry, json and sarif;
  * parity: on das_tpu's shared fixtures (tests/lint_fixtures/, only
    read), the JAX analyzer and the port's give the same (rule, line)
    findings for every rule whose contract names no JAX call;
  * the registries the rules read exist where das_tpu declares them
    (FETCH_SITES, PERSIST_SITES / PERSIST_SCOPES, LOCK_DISCIPLINE), and
    every ROUTE_KEYS / PLANNER_KEYS key is referenced here (DL004's
    test-reference witness)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from das_tpu_torch.analysis import run_analysis
from das_tpu_torch.analysis.__main__ import main
from das_tpu_torch.analysis.core import apply_baseline, iter_rules, load_baseline

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "das_tpu_torch"
BASELINE = PORT / "analysis" / "baseline.json"
JAX_FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"
RULES = tuple(f"DL{i:03d}" for i in range(1, 18))
#: the rules whose contract names no JAX call: the two analyzers agree on
#: das_tpu's fixtures for them
PARITY_RULES = ("DL002", "DL004", "DL006", "DL007", "DL008", "DL009", "DL010",
                "DL014", "DL015", "DL017")


# -- the tree ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree_findings():
    return run_analysis([PORT], tests_dir=REPO / "tests")


def test_tree_is_clean(tree_findings):
    new, _kept, stale = apply_baseline(tree_findings, load_baseline(BASELINE))
    assert not new, "new daslint findings:\n" + "\n".join(f.render() for f in new)
    assert not stale, "stale baseline entries: " + str([(b.rule, b.path) for b in stale])


def test_baseline_entries_are_justified():
    entries = load_baseline(BASELINE)
    assert all(len(b.justification.split()) >= 8 for b in entries)
    # what the baseline keeps: the cross-process gloo staging only
    assert {(b.rule, b.path) for b in entries} <= {
        ("DL010", "das_tpu_torch/parallel/fused_sharded.py")}


def test_all_rules_registered():
    assert [rid for rid, _ in iter_rules()] == list(RULES)


# -- every rule: a bad case fires, a good case stays quiet ---------------------

FIXTURES = {
    "DL001": {
        "bad": {"jobs.py": '''
class _ExecJob:
    def dispatch(self):
        n = self.count.item()
        host = self.vals.cpu()
        self.event.synchronize()
        return fetch(self.out), n, host

    def settle(self, host, out):
        return True


def query_many_dispatch(job):
    return job.staged.wait()
'''},
        "good": {"jobs.py": '''
class _ExecJob:
    def dispatch(self):
        out = run(self.sig)
        self.event.wait(self.stream)  # orders streams on the card
        return stage_many([out])

    def settle(self, host, out):
        return int(host[0]) > 0
'''},
    },
    "DL002": {
        "bad": {"sigs.py": '''
from dataclasses import dataclass


@dataclass
class PlanSig:
    caps: tuple


def run_plan(sig: PlanSig):
    return sig.tiled, PlanSig((1,), True)
'''},
        "good": {"sigs.py": '''
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanSig:
    caps: tuple
    tiled: bool = False


def run_plan(sig: PlanSig):
    return sig.tiled, PlanSig((1,), True)
'''},
    },
    "DL003": {
        "bad": {"cfg.py": '''
import os
from os import getenv

DEVICE = os.environ.get("DAS_DEVICE", "cuda")
'''},
        "good": {"cfg.py": '''
"""Every switch is a field: nothing reads os.environ."""
from dataclasses import dataclass


@dataclass
class Config:
    device: str = "cuda"
'''},
    },
    "DL004": {
        "bad": {"routes.py": '''
ROUTE_KEYS = ("fused", "staged", "dead")
ROUTE_COUNTS = {k: 0 for k in ROUTE_KEYS}


class Job:
    route = "fused"

    def settle(self):
        ROUTE_COUNTS[self.route] += 1


class TreeJob(Job):
    route = "fused_tree"


def answer(ok):
    route = "staged" if ok else "stagd"
    ROUTE_COUNTS[route] += 1
'''},
        "good": {"routes.py": '''
ROUTE_KEYS = ("fused", "fused_tree", "staged")
ROUTE_COUNTS = {k: 0 for k in ROUTE_KEYS}


class Job:
    route = "fused"

    def settle(self):
        ROUTE_COUNTS[self.route] += 1


class TreeJob(Job):
    route = "fused_tree"


def answer():
    ROUTE_COUNTS["staged"] += 1
'''},
    },
    "DL005": {
        "bad": {
            "shared_memory.py": '''
KERNEL_SHARED = {
    "k.cu:scan_kernel": ("tile[256]",),
    "k.cu:gone_kernel": (),
}
''',
            "k.cu": '''
__global__ void scan_kernel(const int* in, int* out) {
  __shared__ int tile[256];
  __shared__ int extra[32];  // a buffer no model prices
}

__global__ void __launch_bounds__(256) set_kernel(long long* x) {
  extern __shared__ long long set[];
}

__device__ void helper() { __shared__ int stray[4]; }

extern "C" int launch(const int* in, int* out, long long* x, void* st) {
  scan_kernel<<<1, 256, 0, (cudaStream_t)st>>>(in, out);
  set_kernel<<<1, 256>>>(x);
  return 0;
}
''',
        },
        "good": {
            "shared_memory.py": '''
KERNEL_SHARED = {
    "k.cu:scan_kernel": ("tile[256]", "extra[32]"),
    "k.cu:set_kernel": ("extern set[]", "dynamic: sizeof(long long) << bits"),
}
''',
            "k.cu": '''
/* __shared__ in a comment is no buffer */
__global__ void scan_kernel(const int* in, int* out) {
  __shared__ int tile[256];
  __shared__ int extra[32];
}

__global__ void __launch_bounds__(256) set_kernel(long long* x) {
  extern __shared__ long long set[];
}

extern "C" int launch(const int* in, int* out, long long* x, int bits, void* st) {
  scan_kernel<<<1, 256, 0, (cudaStream_t)st>>>(in, out);
  set_kernel<<<1, 256, sizeof(long long) << bits, (cudaStream_t)st>>>(x);
  return 0;
}
''',
        },
    },
    "DL006": {
        "bad": {"pool.py": '''
import threading

LOCK_DISCIPLINE = {"Pool._worker": "_lock", "Pool.stats": "worker"}
WORKER_METHODS = {"Pool": ("_run",)}


class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._worker = None
        self.stats = {"n": 0}

    def submit(self):
        self.stats["n"] += 1
        self._worker = threading.Thread(target=self._run)
        self.burst = True
'''},
        "good": {"pool.py": '''
import threading

LOCK_DISCIPLINE = {"Pool._worker": "_lock", "Pool.stats": "worker"}
WORKER_METHODS = {"Pool": ("_run",)}


class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._worker = None
        self.stats = {"n": 0}

    def submit(self):
        with self._lock:
            self._worker = threading.Thread(target=self._run)

    def _run(self):
        self.stats["n"] += 1
'''},
    },
    "DL007": {
        "bad": {"cache.py": '''
def settle(self, key, job):
    self.results.put(key, job.result)
    self.results.put(key, job.result, self.results.version())
'''},
        "good": {"cache.py": '''
def execute(self, key, job):
    version = self.results.version()
    out = job.dispatch()
    self.results.put(key, job.settle(out), version)
'''},
    },
    "DL008": {
        "bad": {"planner.py": '''
ROUTE_KEYS = ("fused",)
PLANNER_KEYS = ("planned", "dead")
PLANNER_COUNTS = {k: 0 for k in PLANNER_KEYS}


def plan(q):
    PLANNER_COUNTS["planned"] += 1
    PLANNER_COUNTS["plannd"] += 1
    return PlannedProgram(route="fussed")
'''},
        "good": {"planner.py": '''
ROUTE_KEYS = ("fused",)
PLANNER_KEYS = ("planned",)
PLANNER_COUNTS = {k: 0 for k in PLANNER_KEYS}


def plan(q):
    PLANNER_COUNTS["planned"] += 1
    return PlannedProgram(route="fused")
'''},
    },
    "DL009": {
        "bad": {
            "mesh.py": '''
import torch.distributed as dist

COLLECTIVE_SITES = ("sharded.gather_rows", "sharded.retired")
COLLECTIVE_HELPERS = ("mesh.all_gather",)


def all_gather(xs, mesh):
    parts = []
    dist.all_gather(parts, xs[0], group=mesh.group)
    return parts


def psum(xs, mesh):
    out = xs[0].clone()
    dist.all_reduce(out, group=mesh.group)
    return out
''',
            "sharded.py": '''
import torch.distributed as dist

from das_tpu_torch.parallel import mesh as M


def gather_rows(t, mesh):
    return M.all_gather([t], mesh)


def count(t, mesh):
    return M.psum([t], mesh)


def sync():
    dist.barrier()
''',
            "kernels/join.py": '''
from das_tpu_torch.parallel import mesh as M


def join(t, mesh):
    return M.psum([t], mesh)
''',
        },
        "good": {
            "mesh.py": '''
import torch.distributed as dist

COLLECTIVE_SITES = ("sharded.gather_rows",)
COLLECTIVE_HELPERS = ("mesh.all_gather",)


def all_gather(xs, mesh):
    def gather(local):
        parts = []
        dist.all_gather(parts, local, group=mesh.group)
        return parts

    return gather(xs[0])
''',
            "sharded.py": '''
from das_tpu_torch.parallel import mesh as M


def gather_rows(t, mesh):
    return M.all_gather([t], mesh)
''',
        },
    },
    "DL010": {
        "bad": {"jobs.py": '''
class _ExecJob:
    def dispatch(self):
        return self._prep()

    def _prep(self):
        return _peek(self.vals)

    def settle(self, host, out):
        return True


def _peek(t):
    return t.cpu()
'''},
        "good": {"jobs.py": '''
class _ExecJob:
    def dispatch(self):
        return self._prep()

    def _prep(self):
        return stage_many([(self.vals,)])

    def settle(self, host, out):
        return _peek(out)


def _peek(t):
    return t.cpu()
'''},
    },
    "DL011": {
        "bad": {
            "kernels/launch.py": '''
_SIGNATURES = {"das_scan": [], "das_scan_scratch": [], "das_gone": []}
_RESTYPES = {"das_scan_scratch": 1}
''',
            "kernels/csrc/k.cu": '''
extern "C" long long das_scan_scratch(long long n) { return n; }
extern "C" int das_scan(const void* in, void* out, long long n) { return 0; }
extern "C" int das_unbound(int x) { return x; }
''',
            "kernels/scan.py": '''
import torch

from das_tpu_torch.kernels import launch


def scan(x):
    if not launch.is_cuda(x):
        return torch.cumsum(x, 0)
    order = torch.argsort(x)
    lib = launch.library()
    try:
        lib.das_scan(x.data_ptr(), order.data_ptr(), x.numel())
    except RuntimeError:
        return scan_plain(x)
    return order
''',
            "serve.py": '''
from das_tpu_torch import kernels


def answer(lv, lm, rv, rm):
    try:
        return kernels.join_tables(lv, lm, rv, rm, (), (), 16)
    except RuntimeError:
        return kernels.join_tables_plain(lv, lm, rv, rm, (), (), 16)
''',
        },
        "good": {
            "kernels/launch.py": '''
_SIGNATURES = {"das_scan": [], "das_scan_scratch": []}
_RESTYPES = {"das_scan_scratch": 1}
''',
            "kernels/csrc/k.cu": '''
extern "C" long long das_scan_scratch(long long n) { return n; }
extern "C" int das_scan(const void* in, void* out, long long n) { return 0; }
''',
            "kernels/scan.py": '''
import torch

from das_tpu_torch.kernels import launch


def scan(x):
    t0 = launch.mark()
    if not launch.is_cuda(x):
        return launch.noted("scan", t0, False, x.shape, torch.cumsum(x, 0))
    out = torch.empty_like(x)
    lib = launch.library()
    err = lib.das_scan(x.data_ptr(), out.data_ptr(), x.numel())
    launch.raise_on(err, "scan")
    launch.count_call("scan", launch.regime_out(), launch.launches_out())
    return launch.noted("scan", t0, True, x.shape, out)
''',
        },
    },
    "DL012": {
        "bad": {"progs.py": '''
import ctypes
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanSig:
    caps: tuple


def run_plan(sig: PlanSig, arrays):
    return arrays


def build_plan(sig: PlanSig, opts: dict):
    def fn(x):
        return x * opts["scale"]

    return fn


class Job:
    def dispatch(self, request: dict):
        run = proflog.instrument("fused", str(id(request)), run_plan)
        entry = build_plan(self.sig, {})
        self.progs[request["id"]] = entry
        return run(self.sig, self.arrays)


def load():
    return ctypes.CDLL("libk.so")
'''},
        "good": {"progs.py": '''
import ctypes
import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanSig:
    caps: tuple


def run_plan(sig: PlanSig, arrays):
    return arrays


def build_plan(sig: PlanSig):
    def fn(x):
        return x * len(sig.caps)

    return fn


class Job:
    def dispatch(self):
        sig = self.plan_sig()
        run = proflog.instrument("fused", proflog.sig_digest(sig, False), run_plan)
        entry = build_plan(sig)
        self.progs[sig] = entry
        return run(sig, self.arrays)


def _library_path():
    return "build/libk_" + hashlib.sha256(b"sources").hexdigest()[:16] + ".so"


def load():
    return ctypes.CDLL(_library_path())
'''},
    },
    "DL013": {
        "bad": {"mod.py": '''
import torch

FETCH_COUNTS = {"n": 0}
FETCH_SITES = {
    "mod.fetch_many": "FETCH_COUNTS",
    "mod.settle": "FETCH_COUNTS",
    "mod.gone": None,
}


def fetch_many(groups):
    FETCH_COUNTS["n"] += 1
    return [t.cpu() for g in groups for t in g]


def settle(out):
    return out.numpy()


def debug(out):
    return out.item()


LEAK = torch.zeros(1).tolist()
'''},
        "good": {"mod.py": '''
FETCH_COUNTS = {"n": 0}
FETCH_SITES = {
    "mod.fetch_many": "FETCH_COUNTS",
    "mod.settle": "FETCH_COUNTS",
    "mod.checkpoint_copy": None,
}


def fetch_many(groups):
    FETCH_COUNTS["n"] += 1
    return [t.cpu() for g in groups for t in g]


def settle(out):
    return fetch_many([out])


def checkpoint_copy(slabs):
    return [t.cpu() for t in slabs]
'''},
    },
    "DL014": {
        "bad": {"obs_use.py": '''
from das_tpu_torch import obs

SPAN_NAMES = ("serve.fetch", "serve.retired")
COUNTER_NAMES = ("serve.fetches",)
HISTOGRAM_NAMES = ("serve.fetch_ms",)


def fetch(job):
    with obs.span("serve.fetch"):
        out = job.run()
    obs.counter("serve.fetches").inc()
    obs.histogram("serve.fetch_ms").observe(out.ms)
    obs.event("serve.fetchh")
    obs.histogram("serve.rows_ms").observe(out.ms)
    return out
'''},
        "good": {"obs_use.py": '''
from das_tpu_torch import obs

SPAN_NAMES = ("serve.fetch",)
COUNTER_NAMES = ("serve.fetches",)
HISTOGRAM_NAMES = ("serve.fetch_ms",)


def fetch(job):
    with obs.span("serve.fetch"):
        out = job.run()
    obs.counter("serve.fetches").inc()
    obs.histogram("serve.fetch_ms").observe(out.ms)
    return out
'''},
    },
    "DL015": {
        "bad": {
            "seams.py": '''
from das_tpu_torch import fault

FAULT_SITES = ("settle_fetch", "retired_seam")


def recover(batch):
    fault.maybe_fail("surprise_seam")
    return batch


class _ExecJob:
    def dispatch(self):
        fault.maybe_fail("settle_fetch")
        return self

    def settle(self, host, out):
        return True
''',
            "kernels/probe.py": '''
from das_tpu_torch import fault


def probe(x):
    fault.maybe_fail("settle_fetch")
    return x
''',
        },
        "good": {"seams.py": '''
from das_tpu_torch import fault

FAULT_SITES = ("settle_fetch",)


class _ExecJob:
    def dispatch(self):
        return self

    def settle(self, host, out):
        fault.maybe_fail("settle_fetch")
        return True
'''},
    },
    "DL016": {
        "bad": {"mod.py": '''
import ctypes
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanSig:
    caps: tuple


PROGRAM_SITES = {"mod.Job.dispatch": "fused", "mod.load": "kernel_build", "mod.gone": "x"}
PROGRAM_INNER_SITES = {"mod.build_tree": "tree"}


def run_plan(sig: PlanSig, arrays):
    return arrays


def build_tree(sig: PlanSig):
    return run_plan


class Job:
    def dispatch(self):
        return run_plan(self.sig, self.arrays)


def load(path):
    return ctypes.CDLL(path)


def execute(sig):
    return run_plan(sig, None)


def note(t0):
    proflog.record_launch("kernal", "probe", (), t0, True)
'''},
        "good": {"mod.py": '''
import ctypes
from dataclasses import dataclass


@dataclass(frozen=True)
class PlanSig:
    caps: tuple


PROGRAM_SITES = {"mod.Job.dispatch": "fused", "mod.load": "kernel_build"}
PROGRAM_INNER_SITES = {"mod.build_tree": "fused"}


def run_plan(sig: PlanSig, arrays):
    return arrays


def build_tree(sig: PlanSig):
    return run_plan


class Job:
    def dispatch(self):
        run = proflog.instrument("fused", proflog.sig_digest(self.sig), run_plan)
        return run(self.sig, self.arrays)


def load(path):
    lib = ctypes.CDLL(path)
    proflog.record_build("kernel_build", path, 0.0, True)
    return lib
'''},
    },
    "DL017": {
        "bad": {"durable.py": '''
import os
from pathlib import Path

import numpy as np
import torch

PERSIST_SCOPES = ()
PERSIST_SITES = ("atomic_write", "gone")


def atomic_write(path, writer):
    with open(path + ".tmp", "wb") as f:
        writer(f)
    os.replace(path + ".tmp", path)


def save(path, obj, arr):
    with open(path, "w") as f:
        f.write("x")
    torch.save(obj, path + "/w.pt")
    np.savez(path + "/a.npz", a=arr)
    Path(path).write_text("x")
'''},
        "good": {"durable.py": '''
import os

import numpy as np
import torch

PERSIST_SCOPES = ()
PERSIST_SITES = ("atomic_write",)


def atomic_write(path, writer):
    with open(path + ".tmp", "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def save(path, obj, arr):
    atomic_write(path + "/w.pt", lambda f: torch.save(obj, f))
    atomic_write(path + "/a.npz", lambda f: np.savez(f, a=arr))
'''},
    },
}


def _write(root: Path, files) -> Path:
    for name, text in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text.lstrip("\n"))
    return root


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("daslint_fixtures")
    return {(rule, kind): _write(base / rule / kind, files)
            for rule, cases in FIXTURES.items() for kind, files in cases.items()}


def test_every_rule_has_both_cases():
    assert set(FIXTURES) == set(RULES)
    assert all(set(cases) == {"bad", "good"} for cases in FIXTURES.values())


@pytest.mark.parametrize("rule", RULES)
def test_bad_case_fires(rule, fixture_dirs):
    findings = run_analysis([fixture_dirs[rule, "bad"]], rules=[rule])
    assert findings, f"{rule}'s bad case tripped nothing"
    assert all(f.rule == rule for f in findings)


@pytest.mark.parametrize("rule", RULES)
def test_good_case_clean(rule, fixture_dirs):
    findings = run_analysis([fixture_dirs[rule, "good"]], rules=[rule])
    assert not findings, "\n".join(f.render() for f in findings)


@pytest.mark.parametrize("rule", RULES)
def test_cli_exit_codes_per_rule(rule, fixture_dirs, tmp_path, capsys):
    common = ["--select", rule, "--no-baseline", "--tests-dir", str(tmp_path / "none")]
    assert main([str(fixture_dirs[rule, "bad"])] + common) == 1
    assert main([str(fixture_dirs[rule, "good"])] + common) == 0
    capsys.readouterr()


def _messages(fixture_dirs, rule):
    return "\n".join(f.message for f in run_analysis([fixture_dirs[rule, "bad"]], rules=[rule]))


def test_bad_cases_name_each_leg(fixture_dirs):
    """Every leg of the port forms fires on its bad case."""
    m = _messages(fixture_dirs, "DL001")
    for what in (".item()", ".cpu()", ".synchronize()", "fetch()", ".wait()"):
        assert what in m, what
    m = _messages(fixture_dirs, "DL003")
    assert "`environ`" in m and "`getenv`" in m
    m = _messages(fixture_dirs, "DL004")
    assert "'fused_tree'" in m and "'stagd'" in m and "'dead'" in m
    m = _messages(fixture_dirs, "DL005")
    assert "unaccounted=['extra[32]']" in m and "`k.cu:set_kernel` is not in" in m
    assert "no launch gives it dynamic" in m and "stray" in m and "k.cu:gone_kernel" in m
    m = _messages(fixture_dirs, "DL009")
    for what in ("`mesh.psum`", "`sharded.count`", "`sharded.sync`", "kernel wrapper",
                 "`sharded.retired`"):
        assert what in m, what
    m = _messages(fixture_dirs, "DL011")
    for what in ("`das_unbound` is not bound", "binds `das_gone`", "does not record",
                 "argsort", "try statement around", "falls back"):
        assert what in m, what
    m = _messages(fixture_dirs, "DL012")
    for what in ("keyed by something other", "`request`", "`opts`", "not its signature",
                 "loads a library"):
        assert what in m, what
    m = _messages(fixture_dirs, "DL013")
    for what in ("without tallying", "undeclared scope `mod.debug`", "outside any function",
                 "`mod.gone`"):
        assert what in m, what
    m = _messages(fixture_dirs, "DL016")
    for what in ("undeclared scope `mod.execute`", "'kernal'", "label 'fused'",
                 "label 'kernel_build'", "`mod.gone`", "label 'tree'"):
        assert what in m, what
    m = _messages(fixture_dirs, "DL017")
    for what in ("no earlier os.fsync", "bare write-mode open()", "torch.save", "'gone'"):
        assert what in m, what
    assert m.count("np.save*/torch.save to a PATH") == 2


# -- the historical bug classes on the port's real source ----------------------


def test_dl002_catches_dropped_sig_field(tmp_path):
    """Drop FusedPlanSig.multiway: run_conj still reads sig.multiway."""
    src = (PORT / "query/fused.py").read_text()
    field = "    multiway: int = 0\n"
    assert src.count(field) == 1, "fused.py layout changed"
    mutated = tmp_path / "fused.py"
    mutated.write_text(src.replace(field, ""))
    findings = run_analysis([mutated], rules=["DL002"])
    assert any("`sig.multiway`" in f.message for f in findings), \
        "\n".join(f.render() for f in findings)
    assert not run_analysis([PORT / "query/fused.py"], rules=["DL002"])


def test_dl010_catches_cpu_moved_into_a_helper(tmp_path):
    """A `.cpu()` in a helper that _ExecJob.dispatch calls: the dispatch
    body stays clean, so only the call-graph rule sees it."""
    src = (PORT / "query/fused.py").read_text()
    anchor = "        sig = self.plan_sig()\n        run = run_conj\n"
    assert src.count(anchor) == 1, "fused.py layout changed"
    mutated = tmp_path / "fused.py"
    mutated.write_text(
        src.replace(anchor, "        _peek(self.fvals)\n" + anchor)
        + "\n\ndef _peek(fvals):\n    return [f.cpu() for f in fvals]\n")
    assert not run_analysis([mutated], rules=["DL001"])
    findings = run_analysis([mutated], rules=["DL010"])
    assert any("`_ExecJob.dispatch` reaches .cpu()" in f.message
               and "_ExecJob.dispatch -> _peek" in f.message for f in findings), \
        "\n".join(f.render() for f in findings)


def test_dl004_catches_undeclared_route_key(tmp_path):
    src = (PORT / "query/compiler.py").read_text()
    needle = 'ROUTE_COUNTS["staged"]'
    assert needle in src, "compiler.py layout changed"
    mutated = tmp_path / "compiler.py"
    mutated.write_text(src.replace(needle, 'ROUTE_COUNTS["stagedd"]', 1))
    findings = run_analysis([mutated, PORT / "ops/counters.py"], rules=["DL004"])
    assert any("'stagedd'" in f.message and "not declared" in f.message
               for f in findings), "\n".join(f.render() for f in findings)


def test_dl017_catches_bare_open_in_persist_module(tmp_path):
    """A bare open(path, "wb") added to checkpoint.save, beside the real
    registry in durable.py (PERSIST_SCOPES match by path suffix)."""
    storage = tmp_path / "das_tpu_torch" / "storage"
    storage.mkdir(parents=True)
    shutil.copy(PORT / "storage/durable.py", storage / "durable.py")
    src = (PORT / "storage/checkpoint.py").read_text()
    anchor = "    os.makedirs(path, exist_ok=True)\n"
    assert src.count(anchor) >= 1, "checkpoint.py layout changed"
    (storage / "checkpoint.py").write_text(src.replace(
        anchor, anchor + '    with open(os.path.join(path, "extra.bin"), "wb") as f:\n'
                         '        f.write(b"x")\n', 1))
    findings = run_analysis([storage], rules=["DL017"])
    assert any("bare write-mode open()" in f.message and "`save`" in f.message
               for f in findings), "\n".join(f.render() for f in findings)
    assert not run_analysis([PORT / "storage"], rules=["DL017"])


# -- false positives of the port forms, pinned ---------------------------------


def test_dl004_resolves_route_through_class_attribute():
    """`ROUTE_COUNTS[self.route]` counts `_TreeExecJob.route` and the
    sharded tree job's override: neither key is dead."""
    findings = run_analysis([PORT / "query/fused.py", PORT / "parallel/fused_sharded.py",
                             PORT / "ops/counters.py", PORT / "query/compiler.py",
                             PORT / "api/atomspace.py", PORT / "mining/miner.py"],
                            rules=["DL004"])
    msgs = "\n".join(f.message for f in findings)
    assert "'fused_tree'" not in msgs and "'sharded_tree_fused'" not in msgs, msgs


def test_dl009_helpers_define_their_collectives():
    """The torch.distributed calls inside mesh.py's helpers are where a
    collective is defined (COLLECTIVE_HELPERS), not a stray collective."""
    from das_tpu_torch.parallel import mesh

    assert set(mesh.COLLECTIVE_HELPERS) == {"mesh.all_gather", "mesh.all_to_all", "mesh._reduce"}
    assert not run_analysis([PORT / "parallel"], rules=["DL009"])


# -- CLI contract --------------------------------------------------------------


def test_cli_whole_tree_subprocess():
    """The acceptance command, end to end, from the repository root."""
    proc = subprocess.run([sys.executable, "-m", "das_tpu_torch.analysis"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout and "0 stale" in proc.stdout


def test_cli_usage_errors(fixture_dirs, tmp_path, capsys):
    bad = str(fixture_dirs["DL013", "bad"])
    assert main([bad, "--select", "DL999"]) == 2
    assert main([bad, "--ignore", "DL0XX"]) == 2
    assert main([str(tmp_path / "nowhere.py")]) == 2
    assert main([bad, "--select", "DL013", "--baseline", str(tmp_path / "none.json")]) == 2
    assert main([bad, "--select", "DL013", "--ignore", "DL013"]) == 0
    assert main(["--list-rules"]) == 0
    assert "DL011" in capsys.readouterr().out


def test_suppression_comment(tmp_path):
    mod = _write(tmp_path / "py", {"cfg.py": FIXTURES["DL003"]["bad"]["cfg.py"]}) / "cfg.py"
    assert run_analysis([mod], rules=["DL003"])
    mod.write_text("# daslint: disable=DL003\n" + mod.read_text())
    assert run_analysis([mod], rules=["DL003"]) == []
    # a quoted directive is no comment
    quoted = tmp_path / "quoted.py"
    quoted.write_text('"""# daslint: disable=DL003"""\n'
                      + FIXTURES["DL003"]["bad"]["cfg.py"])
    assert run_analysis([quoted], rules=["DL003"])
    # a CUDA source takes the directive after `//`
    cu = _write(tmp_path / "cu", FIXTURES["DL005"]["bad"])
    assert any(f.path.endswith(".cu") for f in run_analysis([cu], rules=["DL005"]))
    (cu / "k.cu").write_text("// daslint: disable=DL005\n" + (cu / "k.cu").read_text())
    assert not any(f.path.endswith(".cu") for f in run_analysis([cu], rules=["DL005"]))


def test_stale_baseline_entry_fails(fixture_dirs, tmp_path, capsys):
    good = str(fixture_dirs["DL006", "good"])
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": [{
        "rule": "DL006", "path": "gone.py", "message": "vanished",
        "justification": "stale on purpose"}]}))
    assert main([good, "--select", "DL006", "--baseline", str(bl)]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    assert main([good, "--select", "DL006", "--baseline", str(bl), "--allow-partial"]) == 0
    # an entry of another rule is not searched for in a subset run
    assert main([good, "--select", "DL007", "--baseline", str(bl)]) == 0
    capsys.readouterr()


def test_baseline_grandfathers_and_requires_justification(fixture_dirs, tmp_path, capsys):
    bad = fixture_dirs["DL007", "bad"]
    findings = run_analysis([bad], rules=["DL007"])
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": [
        {"rule": f.rule, "path": f.path, "message": f.message,
         "justification": "fixture keep"} for f in findings]}))
    assert main([str(bad), "--select", "DL007", "--baseline", str(bl)]) == 0
    bl.write_text(json.dumps({"findings": [{"rule": "DL007", "path": "x.py", "message": "m"}]}))
    with pytest.raises(ValueError):
        load_baseline(bl)
    assert main([str(bad), "--select", "DL007", "--baseline", str(bl)]) == 2
    capsys.readouterr()


def test_cli_json_and_sarif(fixture_dirs, capsys):
    bad = str(fixture_dirs["DL001", "bad"])
    assert main([bad, "--select", "DL001", "--no-baseline", "--format", "json"]) == 1
    record = json.loads(capsys.readouterr().out)
    assert record["findings"] and not record["stale_baseline"]
    assert main([bad, "--select", "DL001", "--no-baseline", "--format", "sarif"]) == 1
    run = json.loads(capsys.readouterr().out)["runs"][0]
    assert run["tool"]["driver"]["name"] == "daslint"
    assert run["results"][0]["ruleId"] == "DL001"


# -- parity with the JAX analyzer on das_tpu's fixtures ------------------------


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", PARITY_RULES)
def test_parity_with_jax_analyzer(rule, kind):
    from das_tpu.analysis import run_analysis as jax_run_analysis

    path = JAX_FIXTURES / f"{rule.lower()}_{kind}.py"
    jx = sorted((f.rule, f.line) for f in jax_run_analysis([path], rules=[rule]))
    pt = sorted((f.rule, f.line) for f in run_analysis([path], rules=[rule]))
    assert jx == pt
    assert bool(pt) == (kind == "bad")


# -- the registries the rules read ---------------------------------------------


def test_registries_exist_where_das_tpu_declares_them():
    from das_tpu_torch.obs import proflog, recorder
    from das_tpu_torch.query import fused
    from das_tpu_torch.service import coalesce
    from das_tpu_torch.storage import durable

    assert "fused.settle_pending_iter" in fused.FETCH_SITES
    assert set(fused.FETCH_SITES.values()) <= {"FETCH_COUNTS", "FETCHES", None}
    assert durable.PERSIST_SITES == ("atomic_write", "DeltaLog.append", "_truncate_wal",
                                     "_publish_generation")
    assert "das_tpu_torch/storage/durable.py" in durable.PERSIST_SCOPES
    assert coalesce.LOCK_DISCIPLINE == {"QueryCoalescer._worker": "_lock",
                                        "QueryCoalescer.stats": "worker",
                                        "QueryCoalescer.rejected": "_lock"}
    assert set(recorder.LOCK_DISCIPLINE.values()) == {"_lock"}
    assert set(proflog.LOCK_DISCIPLINE.values()) == {"_lock"}
    assert set(proflog.PROGRAM_INNER_SITES.values()) <= set(proflog.PROGRAM_SITES.values())


def test_kernel_shared_memory_manifest_covers_every_kernel():
    from das_tpu_torch.kernels.shared_memory import KERNEL_SHARED

    csrc = PORT / "kernels" / "csrc"
    assert not run_analysis([csrc, PORT / "kernels" / "shared_memory.py"], rules=["DL005"])
    assert {k.split(":")[0] for k in KERNEL_SHARED} == {
        p.name for p in csrc.iterdir() if "__global__" in p.read_text()}


def test_counter_registry_pins():
    """DL004's test-reference witness: every declared route and planner
    key, quoted."""
    from das_tpu_torch.ops.counters import PLANNER_KEYS, ROUTE_KEYS

    assert ROUTE_KEYS == ("fused", "fused_kernel", "fused_multiway", "fused_tree",
                          "sharded_tree_fused", "staged", "tree", "sharded",
                          "sharded_kernel", "sharded_multiway", "count_kernel", "host",
                          "star")
    assert PLANNER_KEYS == ("planned", "greedy", "dp", "greedy_tail", "ref_order",
                            "programs", "round0", "retries", "est_rows", "actual_rows",
                            "explain")
