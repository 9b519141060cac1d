"""The port's program ledger (das_tpu_torch/obs/proflog.py) and profiler
hooks (obs/torchprof.py): the port's part of tests/test_zprof.py.

  * off, `instrument(...)` is the function itself and a workload records
    nothing; answers are the same on and off;
  * the lifecycle: one first call ("compile") per signature and argument
    shapes, then ledger hits, at the fused, fused_tree, fused_exact,
    count_batch, sharded and sharded_tree sites;
  * kernel launch notes of kind "plain" on the CPU, and the kernel and
    scanner builds as the cold start;
  * `program_model_bytes` / `tree_model_bytes` equal das_tpu's for the same
    signatures and shapes;
  * `explain(compile=True)` rows and `coalescer_stats()["programs"]` carry
    das_tpu's keys; the compile span lands in the trace ring;
  * PROGRAM_SITES is pinned against the source;
  * `torchprof.annotation` is the no-op span when off, and a
    `maybe_start_trace` / `maybe_stop_trace` pair writes a Chrome trace
    holding `exec.dispatch`.

Everything runs on device="cpu" (the kernels' plain versions)."""

import ast as pyast
import dataclasses
import json
import os
from pathlib import Path

import pytest

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.obs import proflog as jx_proflog
from das_tpu.parallel import fused_sharded as jx_fs
from das_tpu.parallel.mesh import make_mesh as jx_make_mesh
from das_tpu.parallel.sharded_db import ShardedDB as JxShardedDB
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query import fused as jx_fused
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch import obs
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.obs import proflog, torchprof
from das_tpu_torch.parallel import fused_sharded as fs
from das_tpu_torch.parallel.sharded_db import ShardedDB
from das_tpu_torch.query import ast, compiler, fused
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.tensor_db import TensorDB

ROOT = Path(__file__).resolve().parent.parent
BIO = dict(n_genes=40, n_processes=10, members_per_gene=3, n_interactions=50, seed=5)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Ledger, recorder and annotations off again after every test: they
    are process-wide, and the rest of the suite runs the off path."""
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_STAR",
                "DAS_TPU_TREE_FUSION", "DAS_TPU_VMEM_BUDGET", "DAS_TPU_PLANNER_DP_MAX"):
        monkeypatch.delenv(var, raising=False)
    yield
    proflog.reset()
    proflog.configure(enabled=False)
    obs.reset()
    obs.configure(enabled=False, annotations=False)


@pytest.fixture
def ledger():
    proflog.configure(enabled=True)
    proflog.reset()


def _inherit(m, anchor="animal"):
    return m.And([
        m.Link("Inheritance", [m.Variable("$1"), m.Variable("$2")], True),
        m.Link("Inheritance", [m.Variable("$2"), m.Node("Concept", anchor)], True),
    ])


def _tensor_das():
    return DistributedAtomSpace(backend="tensor", device="cpu",
                                data=load_metta_text(animals_metta()))


def _sharded_das(**cfg):
    return DistributedAtomSpace(backend="sharded", device="cpu",
                                data=load_metta_text(animals_metta()),
                                config=DasConfig(mesh_shape=(4,), **cfg))


# -- off ------------------------------------------------------------------------


def test_disabled_instrument_is_identity():
    assert not proflog.enabled()

    def fn(x):
        return x

    assert proflog.instrument("fused", "deadbeef", fn) is fn
    assert proflog.launch_mark() == 0.0


def test_disabled_workload_records_nothing():
    das = _tensor_das()
    ok, ans = das.query_answer(_inherit(ast))
    assert ok and ans.assignments
    snap = proflog.snapshot()
    assert snap["enabled"] is False
    assert (snap["compiles"], snap["entries"], snap["launches"], snap["calls"]) == (0, 0, 0, 0)


def test_answers_bit_identical_on_vs_off(ledger):
    _ok, on = _tensor_das().query_answer(_inherit(ast))
    assert proflog.snapshot()["compiles"] >= 1
    proflog.configure(enabled=False)
    _ok, off = _tensor_das().query_answer(_inherit(ast))
    assert on.assignments == off.assignments and on.assignments


# -- the lifecycle ----------------------------------------------------------------


def _run_site(site):
    """Run one site's workload twice with the same shapes."""
    if site in ("fused", "fused_exact"):
        db = TensorDB(load_metta_text(animals_metta()), device="cpu")
        ex = fused.get_executor(db)
        plans = compiler.plan_query(db, _inherit(ast))
        for _ in range(2):
            if site == "fused":
                res = ex.execute(plans)
            else:
                res = ex.execute_exact(plans)
            assert res.count > 0
    elif site == "fused_tree":
        das = _tensor_das()
        q = ast.Or([_inherit(ast, "animal"), _inherit(ast, "mammal")])
        for _ in range(2):
            fused.get_executor(das.db).tree_results.clear()
            ok, ans = das.query_answer(q)
            assert ok and ans.assignments
    elif site == "count_batch":
        db = TensorDB(load_metta_text(animals_metta()), device="cpu")
        plans = [compiler.plan_query(db, _inherit(ast, a)) for a in ("animal", "mammal")]
        for _ in range(2):
            fused.get_executor(db).results.clear()
            assert all(c is not None for c in fused.get_executor(db).count_batch(plans))
    elif site == "sharded":
        das = _sharded_das()
        ex = fs.get_sharded_executor(das.db)
        plans = compiler.plan_query(das.db, _inherit(ast))
        for _ in range(2):
            assert ex.execute(plans).count > 0
    else:  # sharded_tree
        das = _sharded_das()
        q = ast.Or([_inherit(ast, "animal"), _inherit(ast, "mammal")])
        for _ in range(2):
            fs.get_sharded_executor(das.db).tree_results.clear()
            ok, ans = das.query_answer(q)
            assert ok and ans.assignments


SITES = ("fused", "fused_exact", "fused_tree", "count_batch", "sharded", "sharded_tree")


@pytest.mark.parametrize("site", SITES)
def test_lifecycle_compile_then_hits(ledger, site):
    _run_site(site)
    rows = proflog.rows(site=site)
    assert rows, site
    assert sum(r["compiles"] for r in rows) >= 1
    assert sum(r["hits"] for r in rows) >= 1, rows
    for r in rows:
        assert r["kind"] == "eager" and r["error"] is None
        assert r["calls"] == r["compiles"] + r["hits"]
        if r["compiles"]:
            assert r["compile_s"] > 0 and r["first_compile_s"] > 0
            assert r["arg_bytes"] > 0 and r["out_bytes"] > 0
            # on the CPU: no allocator peak, no cost model
            assert r["peak_bytes"] is None and r["temp_bytes"] is None
            assert r["flops"] is None and r["bytes_accessed"] is None
        if site in ("fused", "count_batch", "sharded", "sharded_tree", "fused_tree"):
            assert r["modeled_bytes"] and r["modeled_bytes"] > 0
    snap = proflog.snapshot()
    assert snap["compiles"] == sum(r["compiles"] for r in proflog.rows() if r["kind"] == "eager")
    assert snap["hit_rate"] > 0


def test_kernel_launch_notes_plain_on_cpu(ledger):
    ok, _ans = _tensor_das().query_answer(_inherit(ast))
    assert ok
    rows = proflog.rows(site="kernel")
    assert rows and all(r["kind"] == "plain" for r in rows)
    assert sum(r["launches"] for r in rows) == proflog.snapshot()["launches"] >= 1
    assert all(r["compile_s"] == 0.0 and r["trace_s"] > 0 for r in rows)


def test_ledger_failure_never_costs_an_answer(ledger, monkeypatch):
    def broken(_args):
        raise RuntimeError("ledger bookkeeping failed")

    monkeypatch.setattr(proflog, "_shape_key", broken)
    ok, ans = _tensor_das().query_answer(_inherit(ast))
    assert ok and ans.assignments
    assert proflog.snapshot()["errors"] >= 1
    assert "bookkeeping" in proflog.rows(site="fused")[0]["error"]


def test_wrapped_call_error_propagates(ledger):
    def fails(*_a):
        raise RuntimeError("das_tpu_torch probe kernel launch failed: CUDA error 700")

    with pytest.raises(RuntimeError, match="CUDA error 700"):
        proflog.instrument("fused", "d0", fails)(1)
    assert proflog.snapshot()["errors"] == 0


def test_scanner_build_is_cold_start_then_cache_hit(ledger, monkeypatch, tmp_path):
    from das_tpu_torch.ingest import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    native.get_lib()                       # a fresh g++ build
    monkeypatch.setattr(native, "_lib", None)
    native.get_lib()                       # a load of the built library
    (row,) = proflog.rows(site="scanner_build")
    assert row["kind"] == "build" and row["compiles"] == 2
    snap = proflog.snapshot()
    assert snap["cold_start_s"] == pytest.approx(row["first_compile_s"], abs=1e-4)
    assert snap["cold_start_s"] > 0 and snap["persistent_cache_hits"] == 1
    assert row["persistent_cache_hit"] is True


# -- the byte model -----------------------------------------------------------------


def _bio_queries(m, g0, g1):
    L, V, N = m.Link, m.Variable, m.Node
    return [
        m.And([L("Member", [N("Gene", g0), V("V3")], True),
               L("Member", [V("V2"), V("V3")], True)]),
        m.And([L("Member", [V("V1"), V("V3")], True),
               L("Member", [N("Gene", g1), V("V3")], True),
               L("Interacts", [V("V1"), V("V2")], True)]),
        m.And([L("Member", [V("V2"), V("V3")], True),
               L("Member", [N("Gene", g1), V("V3")], True),
               m.Not(L("Interacts", [N("Gene", g1), V("V2")], True))]),
        m.And([L("Member", [N("Gene", g0), V("V1")], True),
               L("Member", [N("Gene", g1), V("V1")], True),
               L("Member", [V("V2"), V("V1")], True)]),
    ]


def _jx_kernel_sig(sig):
    return dataclasses.replace(sig, use_kernels=True)


@pytest.mark.parametrize("backend", ["tensor", "sharded"])
def test_program_model_bytes_equal_das_tpu(backend):
    jdata, genes, _ = jx_bio(**BIO)
    pdata, _, _ = build_bio_atomspace(**BIO)
    names = [jdata.nodes[h].name for h in genes[:2]]
    if backend == "tensor":
        jdb, pdb = JxTensorDB(jdata, JxConfig()), TensorDB(pdata, device="cpu")
        jex, pex = jx_fused.get_executor(jdb), fused.get_executor(pdb)
    else:
        jdb = JxShardedDB(jdata, JxConfig(), mesh=jx_make_mesh(8))
        pdb = ShardedDB(pdata, DasConfig(mesh_shape=(8,)), device="cpu")
        jex, pex = jx_fs.get_sharded_executor(jdb), fs.get_sharded_executor(pdb)
        jex.broadcast_limit = pex.broadcast_limit = 0   # hash-partitioned steps too
    seen = 0
    for jq, pq in zip(_bio_queries(jx_ast, *names), _bio_queries(ast, *names)):
        jj = jex._exec_job(jx_compiler.plan_query(jdb, jq), False)
        pj = pex._exec_job(compiler.plan_query(pdb, pq), False)
        want = jx_fused.program_model_bytes(_jx_kernel_sig(jj.plan_sig()), jj.arrays)
        assert fused.program_model_bytes(pj.plan_sig(), pj.arrays) == want > 0
        seen += 1
    assert seen == 4
    # a two-site tree: the largest site's bytes
    jsites = [jex._exec_job(jx_compiler.plan_query(jdb, q), True)
              for q in _bio_queries(jx_ast, *names)[:2]]
    psites = [pex._exec_job(compiler.plan_query(pdb, q), True)
              for q in _bio_queries(ast, *names)[:2]]
    jtree = type("T", (), {"sites": tuple(_jx_kernel_sig(j.plan_sig()) for j in jsites),
                           "neg": None})
    ptree = type("T", (), {"sites": tuple(j.plan_sig() for j in psites), "neg": None})
    assert (fused.tree_model_bytes(ptree, *((j.arrays,) for j in psites))
            == jx_fused.tree_model_bytes(jtree, *((j.arrays,) for j in jsites)) > 0)


# -- the consumers ------------------------------------------------------------------


def _jx_row_keys():
    return set(jx_proflog.ProgramLedger(enabled=False)._entry("s", "d", "jit"))


def test_explain_compile_rows_have_das_tpu_keys(ledger):
    das = _tensor_das()
    out = das.explain(_inherit(ast), compile=True)
    comp = out["compile"]
    assert comp["enabled"] is True and comp["rows"], out
    assert comp["rows"][0]["digest"] == comp["digest"]
    assert set(comp["rows"][0]) == _jx_row_keys()
    assert out["actual"]["count"] > 0
    tree = das.explain(ast.Or([_inherit(ast, "animal"), _inherit(ast, "mammal")]), compile=True)
    assert tree["compile"]["rows"] and tree["compile"]["rows"][0]["site"] == "fused_tree"


def test_explain_compile_disabled_reports_enabled_false():
    das = _tensor_das()
    out = das.explain(_inherit(ast), compile=True)
    assert out["compile"]["enabled"] is False and out["compile"]["rows"] == []


def test_programs_in_service_stats_and_prometheus(ledger):
    from das_tpu_torch.service.server import DasService

    svc = DasService(backend="tensor", device="cpu")
    progs = svc.coalescer_stats()["programs"]
    assert set(progs) == set(jx_proflog.ProgramLedger(enabled=False).snapshot())
    assert progs["enabled"] is True
    text = svc.metrics_text()
    for name in ("das_tpu_obs_programs_compiles", "das_tpu_obs_programs_compile_s",
                 "das_tpu_obs_programs_cold_start_s", "das_tpu_obs_prof_compile_ms"):
        assert name in text


def test_compile_span_lands_in_trace_ring(ledger):
    obs.configure(enabled=True)
    obs.reset()
    ok, _ = _tensor_das().query_answer(_inherit(ast))
    assert ok
    comp = [e for e in obs.events() if e[0] == "prof.compile"]
    assert comp and comp[0][6] == "compile"


def _ledger_call_sites():
    """{module.qualname of the outermost function: site literal} of every
    proflog.instrument / record_launch / record_build call in the port."""
    found = {}
    for path in sorted((ROOT / "das_tpu_torch").rglob("*.py")):
        if path.name == "proflog.py":
            continue
        tree = pyast.parse(path.read_text())

        def walk(node, prefix):
            in_function = bool(prefix) and prefix[-1][1]
            for child in pyast.iter_child_nodes(node):
                if isinstance(child, (pyast.FunctionDef, pyast.ClassDef)) and not in_function:
                    walk(child, prefix + [(child.name, isinstance(child, pyast.FunctionDef))])
                    continue
                if (isinstance(child, pyast.Call) and isinstance(child.func, pyast.Attribute)
                        and isinstance(child.func.value, pyast.Name)
                        and child.func.value.id == "proflog"
                        and child.func.attr in ("instrument", "record_launch", "record_build")):
                    scope = ".".join([path.stem, *(n for n, _ in prefix)])
                    found[scope] = child.args[0].value
                walk(child, prefix)

        walk(tree, [])
    return found


def test_program_sites_pinned():
    assert _ledger_call_sites() == proflog.PROGRAM_SITES


# -- the profiler hooks --------------------------------------------------------------


def test_annotation_is_noop_span_when_off():
    assert torchprof.annotation("exec.dispatch") is obs.NOOP_SPAN
    assert obs.annotation("exec.settle_fetch") is obs.NOOP_SPAN
    obs.configure(annotations=True)
    assert obs.annotation("exec.dispatch") is not obs.NOOP_SPAN
    assert not torchprof.maybe_start_trace(DasConfig())
    assert not torchprof.maybe_stop_trace()


def test_profiler_trace_holds_exec_dispatch(tmp_path):
    obs.configure(annotations=True)
    assert obs.maybe_start_trace(DasConfig(profiler_trace_dir=str(tmp_path)))
    ok, _ = _tensor_das().query_answer(_inherit(ast))
    assert ok and obs.maybe_stop_trace()
    path = torchprof.last_trace_path()
    assert os.path.dirname(path) == str(tmp_path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "exec.dispatch" in names
