"""Commits, checkpoints and snapshots of the port's sharded store, its miner
and a service tenant on it (8 shards on device="cpu"), against das_tpu's
sharded backend on 8 virtual CPU devices:

  * the slabs bit for bit after incremental commits (a new arity among
    them) and after SlabCapacityExhausted's re-partition, with the commit
    counters and the answers;
  * save_sharded's slab section against das_tpu's arrays, the restore
    that uploads it, and the declines (another shard count, a content
    change that keeps the counts);
  * a generational snapshot's slab section, and restore (with WAL replay)
    into a sharded store;
  * the pattern miner on the sharded store against das_tpu's, and a
    DasService tenant with `backend="sharded"`."""

import os
import re
import time
from ast import literal_eval

import numpy as np
import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.mining import PatternMiner as JxMiner
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.service.server import DasService as JxService
from das_tpu.storage import checkpoint as jx_checkpoint
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu.storage.memory_db import MemoryDB as JxMemoryDB
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.mining import PatternMiner
from das_tpu_torch.models.animals import animals_metta, write_animals_metta
from das_tpu_torch.parallel import mesh as M
from das_tpu_torch.parallel.sharded_db import ShardedDB
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.service.server import DasService
from das_tpu_torch.storage import checkpoint, durable
from das_tpu_torch.storage.atom_table import load_metta_text
from tests.test_torch_commit import BEAR, LION_TIGER, LIST3, QUERIES, _commit_both
from tests.test_torch_mesh import _slabs_equal
from tests.test_torch_miner import _animals_run
from tests.test_torch_query import _answer, _build

S = 8
#: test_torch_commit's queries but its unordered join, which das_tpu's mesh
#: tree takes ~30 s to compile here (tests/test_torch_sharded_tree.py holds
#: the unordered shapes)
ORDERED = [q for i, q in enumerate(QUERIES) if i != 3]


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    monkeypatch.setenv("DAS_TPU_STAR_FOLD", "host")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_STAR",
                "DAS_TPU_SNAPSHOT_DIR", "DAS_TPU_WAL", "DAS_TPU_CHECKPOINT"):
        monkeypatch.delenv(var, raising=False)


def _pair(**cfg):
    jx = JxDAS(backend="sharded", data=jx_load(jx_animals()),
               config=JxConfig(use_planner="off", use_multiway="off", **cfg))
    pt = DistributedAtomSpace(backend="sharded", data=load_metta_text(animals_metta()),
                              device="cpu", config=DasConfig(use_planner="off",
                                                             use_multiway="off",
                                                             mesh_shape=(S,), **cfg))
    return jx, pt


def _check(pair, queries=ORDERED):
    jx, pt = pair
    _slabs_equal(jx.db, pt.db)
    for name in ("delta_version", "_delta_total"):
        assert getattr(pt.db, name) == getattr(jx.db, name), name
    assert pt.db.fin.hex_of_row == jx.db.fin.hex_of_row
    for spec in queries:
        assert _answer(pt, _build(ast, spec)) == _answer(jx, _build(jx_ast_mod(), spec)), spec


def jx_ast_mod():
    from das_tpu.query import ast as jx_ast

    return jx_ast


def test_commits_extend_slabs_as_das_tpu():
    pair = _pair()
    jx, pt = pair
    _commit_both(pair, LION_TIGER)
    _commit_both(pair, BEAR)
    assert pt.db.delta_version == 3 and pt.db.tables.n_shards == S
    _check(pair)
    _commit_both(pair, LIST3)       # a new arity: the delta is its base
    _commit_both(pair, ['(List "monkey" "chimp" "human")'])
    assert 3 in pt.db.tables.buckets
    _check(pair, QUERIES[:2])


def test_slab_exhaustion_repartitions_as_das_tpu():
    pair = _pair()
    jx, pt = pair
    tables0 = pt.db.tables
    k = 0
    while pt.db.tables is tables0:
        lines = [f'(: "g{k}_{i}" Concept)' for i in range(40)]
        lines += [f'(Inheritance "g{k}_{i}" "mammal")' for i in range(40)]
        _commit_both(pair, lines)
        k += 1
        assert k < 10, "the slack never ran out"
        _check(pair, QUERIES[:2])
    assert pt.db._delta_total == 0 and jx.db._delta_total == 0   # a re-partition
    assert pt.db.tables.buckets[2].size == 26 + 40 * k


def test_save_sharded_and_restore(tmp_path):
    jx, pt = _pair()
    path = str(tmp_path / "ck")
    pt.save_checkpoint(path)
    jpath = str(tmp_path / "jck")
    jx.save_checkpoint(jpath)
    with np.load(os.path.join(path, f"sharded_{S}.npz")) as got, \
            np.load(os.path.join(jpath, f"sharded_{S}.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert np.array_equal(got[name], want[name]), name
    restored = ShardedDB(checkpoint.load(path), DasConfig(mesh_shape=(S,), checkpoint_path=path),
                         device="cpu")
    assert restored.tables.restored
    _slabs_equal(jx.db, restored)
    q = _build(ast, QUERIES[1])
    assert _answer(DistributedAtomSpace(backend="sharded", device="cpu", config=DasConfig(
        mesh_shape=(S,), checkpoint_path=path)), q) == _answer(pt, q)
    # another shard count: no slab file for it
    assert checkpoint.try_restore_sharded(path, restored.fin, M.make_mesh(4, device="cpu")) is None
    # the same counts, another content: the fingerprint declines
    moved = ('(Inheritance "vine" "plant")', '(Inheritance "vine" "animal")')
    changed = load_metta_text(animals_metta().replace(*moved)).finalize()
    assert (changed.atom_count, changed.node_count) == (restored.fin.atom_count,
                                                        restored.fin.node_count)
    assert checkpoint.try_restore_sharded(path, changed, restored.mesh) is None
    assert jx_checkpoint.try_restore_sharded(
        jpath, jx_load(jx_animals().replace(*moved)).finalize(), jx.db.mesh) is None


def test_snapshot_slab_section_and_restore(tmp_path):
    jx, pt = _pair()
    root = str(tmp_path / "snap")
    gen = pt.save_snapshot(root)
    manifest = durable.read_manifest(gen)
    assert f"sharded_{S}.npz" in manifest["sections"]
    _commit_both((jx, pt), LION_TIGER)          # into the generation's WAL
    # the slabs uploaded from the generation, the commit replayed as a delta
    restored = ShardedDB.restore(root, DasConfig(mesh_shape=(S,)), device="cpu")
    assert restored.tables.restored
    assert restored.delta_version == pt.db.delta_version
    for spec in ORDERED:
        got, want = ast.PatternMatchingAnswer(), ast.PatternMatchingAnswer()
        assert (compiler.dispatch(restored, _build(ast, spec), got)
                == compiler.dispatch(pt.db, _build(ast, spec), want))
        assert got.assignments == want.assignments, spec
    # no commit after the snapshot: the slabs come back bit for bit
    root2 = str(tmp_path / "snap2")
    pt2 = _pair()[1]
    pt2.save_snapshot(root2)
    back = ShardedDB.restore(root2, DasConfig(mesh_shape=(S,)), device="cpu")
    assert back.tables.restored
    for arity, b in pt2.db.tables.buckets.items():
        got = back.tables.buckets[arity].host()
        for name, arr in b.host().items():
            assert np.array_equal(got[name], arr), (arity, name)


def test_miner_on_sharded_equals_das_tpu(monkeypatch):
    want = _animals_run(JxMiner, JxMemoryDB(jx_load(jx_animals())))
    db = ShardedDB(load_metta_text(animals_metta()), DasConfig(mesh_shape=(S,)), device="cpu")
    compiler.reset_route_counts()
    assert _animals_run(PatternMiner, db) == want
    # ordered joints fold on the host; unordered candidates ride the mesh
    assert compiler.ROUTE_COUNTS["star"] > 0 and compiler.ROUTE_COUNTS["sharded"] > 0
    assert compiler.ROUTE_COUNTS["host"] == 0


def _status_answer(status):
    """A HANDLE answer as a set: the negation flag and the sorted list of
    its assignments, each with its keys sorted (the packages print an
    answer's assignments, and their keys, in orders that differ)."""
    msg = status["msg"]
    return (msg.startswith("NOT "),
            sorted(tuple(sorted(literal_eval(d).items()))
                   for d in re.findall(r"\{[^{}]*\}", msg)))


def test_service_sharded_tenant(tmp_path):
    kb = write_animals_metta(str(tmp_path / "animals.metta"))
    svc = DasService(backend="sharded", device="cpu", config=DasConfig(mesh_shape=(S,)))
    ref = JxService(backend="sharded")              # 8 virtual CPU devices
    keys = []
    for s in (svc, ref):
        key = s.create({"name": "animals"})["msg"]
        s.load_knowledge_base({"key": key, "url": f"file://{kb}"})
        for _ in range(400):
            if s.check_das_status({"key": key})["msg"] != "Loading knowledge base":
                break
            time.sleep(0.02)
        keys.append(key)
    assert isinstance(svc.tenants[keys[0]].das.db, ShardedDB)
    assert type(ref.tenants[keys[1]].das.db).__name__ == "ShardedDB"
    compiler.reset_route_counts()
    queries = ["Node n1 Concept human, Link Inheritance n1 $1",
               "Link Inheritance $1 $2, Link Inheritance $2 $3, AND",
               "Node n1 Concept human, Link Similarity n1 $1, Link Inheritance n1 $1, OR"]
    for q in queries:
        got = svc.query({"key": keys[0], "query": q})
        want = ref.query({"key": keys[1], "query": q})
        assert got["success"] and want["success"], (got, want)
        assert _status_answer(got) == _status_answer(want), q
        assert _status_answer(got)[1], q
    stats = svc.coalescer_stats()
    assert stats["routes"]["sharded"] > 0
    assert stats["tenants"]["animals"]["backend"] == "sharded"
