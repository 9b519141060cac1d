"""The port's mesh across two processes (das_tpu_torch/parallel/mesh.py
multihost_initialize, parallel/sharded_db.py, parallel/fused_sharded.py)
against das_tpu's ShardedFusedExecutor on a 4-device mesh.

Two worker processes of the port alone join one gloo group on 127.0.0.1,
each holding 2 of the S = 4 slabs on "cpu", build the animals KB and run
four count-only plans through the sharded executor: tests/test_multihost.py's
query (an index join), a Not, a multiway star and a template join that
hash-partitions (broadcast_limit 0), so that psum, pmax, all_gather and
all_to_all cross the process boundary.  The parent holds every stats
vector, bit for bit, against both ranks' and against das_tpu's on the 8
virtual CPU devices tests/conftest.py forces, and every count against the
host algebra.  Materializing answers, the tree executor, a commit and a
snapshot raise NotImplementedError on the two-process mesh."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.parallel import fused_sharded as jx_fs
from das_tpu.parallel.mesh import make_mesh as jx_make_mesh
from das_tpu.parallel.sharded_db import ShardedDB as JxShardedDB
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu.storage.memory_db import MemoryDB as JxMemoryDB

S = 4

#: (name, broadcast_limit or None for the default)
QUERIES = (("index_join", None), ("not", None), ("star", None), ("partitioned", 0))


def _query(m, name):
    L, V, N, TV = m.Link, m.Variable, m.Node, m.TypedVariable
    inh = lambda a, b: L("Inheritance", [a, b], True)  # noqa: E731
    return {
        "index_join": m.And([inh(V("V1"), V("V3")), inh(V("V2"), V("V3"))]),
        "not": m.And([inh(V("V1"), V("V3")), inh(V("V2"), V("V3")),
                      m.Not(inh(V("V1"), N("Concept", "mammal")))]),
        "star": m.And([inh(V("V1"), V("V3")), inh(V("V2"), V("V3")),
                       inh(V("V4"), V("V3"))]),
        "partitioned": m.And([inh(V("V1"), V("V2")), m.LinkTemplate(
            "Inheritance", [TV("V2", "Concept"), TV("V3", "Concept")], True)]),
    }[name]


# the worker carries its own copy of _query (it imports only the port)
WORKER = textwrap.dedent("""
    import json, os, shutil, sys, tempfile
    sys.path.insert(0, sys.argv[3])
    import torch
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.parallel import mesh as M
    from das_tpu_torch.parallel.fused_sharded import BROADCAST_LIMIT, get_sharded_executor
    from das_tpu_torch.parallel.sharded_db import ShardedDB
    from das_tpu_torch.query import ast as m
    from das_tpu_torch.query import compiler, fused
    from das_tpu_torch.storage import checkpoint, durable
    from das_tpu_torch.storage.atom_table import load_metta_text

    QUERY_SRC

    coordinator, pid, queries = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[4])
    M.multihost_initialize(coordinator, num_processes=2, process_id=pid, timeout_s=60)
    mesh = M.make_mesh(4, device="cpu")
    assert (mesh.size, mesh.n_local, mesh.process_count) == (4, 2, 2), mesh
    assert list(mesh.local_shards) == [2 * pid, 2 * pid + 1]
    db = ShardedDB(load_metta_text(animals_metta()), DasConfig(), mesh=mesh)
    ex = get_sharded_executor(db)
    out = {"pid": pid, "queries": {}}
    for name, limit in queries:
        ex.broadcast_limit = BROADCAST_LIMIT if limit is None else limit
        job = ex._exec_job(compiler.plan_query(db, QUERY(m, name)), True)
        while True:
            dev = job.dispatch()
            host = fused.fetch(*dev)
            if job.settle(host, dev):
                break
        out["queries"][name] = {
            "stats": [int(x) for x in host[0]], "count": job.result.count,
            "rounds": job.rounds, "multiway": job.multiway,
            "index_joins": list(job.index_joins), "exch_caps": list(job.exch_caps)}
    q = QUERY(m, "index_join")
    out["count_matches"] = compiler.count_matches(db, q)
    raised = {}
    plans = compiler.plan_query(db, q)

    def commit():
        load_metta_text('(Inheritance "ent" "animal")', db.data)
        db.refresh()

    target = tempfile.mkdtemp()
    for what, call in (("materialize", lambda: ex.execute(plans)),
                       ("query", lambda: compiler.dispatch(db, q, m.PatternMatchingAnswer())),
                       ("tree", lambda: db.tree_ops),
                       ("snapshot", lambda: checkpoint.save_sharded(db, target)),
                       ("generation", lambda: durable.write_snapshot(db, target)),
                       ("commit", commit)):
        try:
            call()
            raised[what] = None
        except NotImplementedError as e:
            raised[what] = str(e)
    out["raised"] = raised
    out["written"] = os.listdir(target)
    shutil.rmtree(target, ignore_errors=True)
    out["collectives"] = {k: v["calls"] for k, v in M.COLLECTIVE_STATS.items()}
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
""")


def _worker_source():
    import inspect

    return WORKER.replace("QUERY_SRC", inspect.getsource(_query).replace("def _query", "def QUERY"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _das_tpu_runs():
    jdb = JxShardedDB(jx_load(jx_animals()), JxConfig(), mesh=jx_make_mesh(S))
    ex = jx_fs.get_sharded_executor(jdb)
    out = {}
    import jax

    for name, limit in QUERIES:
        ex.broadcast_limit = jx_fs.BROADCAST_LIMIT if limit is None else limit
        job = ex._exec_job(jx_compiler.plan_query(jdb, _query(jx_ast, name)), True)
        while True:
            dev = job.dispatch()
            host = jax.device_get(dev)
            if job.settle(host, dev):
                break
        # a count-only round returns the stats vector alone
        stats = np.asarray(host[0] if isinstance(host, (tuple, list)) else host)
        out[name] = {"stats": [int(x) for x in stats], "count": job.result.count,
                     "rounds": job.rounds, "multiway": job.multiway,
                     "index_joins": list(job.index_joins), "exch_caps": list(job.exch_caps)}
    return jdb, out


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Both workers' RESULT objects (rank order), das_tpu's runs and the
    host answers' sizes.  The workers start first and run while the parent
    compiles das_tpu's programs."""
    script = tmp_path_factory.mktemp("multihost") / "worker.py"
    script.write_text(_worker_source())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(script), coordinator, str(pid), repo,
         json.dumps([list(q) for q in QUERIES])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=repo, env=env, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        jdb, jx_runs = _das_tpu_runs()
        host = JxMemoryDB(jdb.data)
        host_counts = {}
        for name, _ in QUERIES:
            a = jx_ast.PatternMatchingAnswer()
            _query(jx_ast, name).matched(host, a)
            host_counts[name] = len(a.assignments)
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        # a worker that died mid-collective leaves its peer waiting: never
        # leak the pair
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"worker {pid} printed no result:\n{out}"
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results, jx_runs, host_counts


@pytest.mark.parametrize("name", [q for q, _ in QUERIES])
def test_two_process_stats_equal_das_tpu(two_process_run, name):
    results, jx_runs, host_counts = two_process_run
    r0, r1 = (r["queries"][name] for r in results)
    assert r0 == r1, "both ranks read the same replicated stats"
    assert r0 == jx_runs[name]
    assert r0["count"] == host_counts[name] > 0


def test_two_process_routes_cross_the_boundary(two_process_run):
    """The four plans reach an index join, the anti join, a multiway star
    and a hash-partitioned join, and every collective crossed processes."""
    results, _, _ = two_process_run
    q = results[0]["queries"]
    assert any(p >= 0 for p in q["index_join"]["index_joins"])
    assert q["star"]["multiway"] >= 3
    assert q["partitioned"]["exch_caps"][0] > 0
    assert len(q["not"]["stats"]) > len(q["index_join"]["stats"])  # the anti term's range
    for r in results:
        assert all(n > 0 for n in r["collectives"].values()), r["collectives"]
        assert r["count_matches"] == q["index_join"]["count"]


@pytest.mark.parametrize("what", ["materialize", "query", "tree", "snapshot", "generation",
                                  "commit"])
def test_two_process_answers_raise(two_process_run, what):
    results, _, _ = two_process_run
    for r in results:
        msg = r["raised"][what]
        assert msg is not None and "2 processes" in msg, (what, msg)
        assert r["written"] == []   # raised before writing anything
