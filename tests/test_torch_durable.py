"""Durability of the port (das_tpu_torch/storage/checkpoint.py and
durable.py, device="cpu") against the JAX package's (das_tpu, JAX on the
CPU): the same stores and transactions through both leave decoded record,
registry and WAL payloads that are equal (the port writes JSON where the
JAX package writes msgpack; tuples decode as lists in both), equal
`indexes.npz` arrays, content fingerprints and manifests (but for section
names, sizes, CRCs, `created_unix` and `xla_cache_dir`), and, after
snapshot, commits and restore, device tables equal bit for bit, the same
`delta_version` and `_delta_total`, and equal answers, on animals and on
a small bio KB, through a full-rebuild record, a torn WAL tail and a
corrupt section.  Then the port alone: crash points (a failing rename, a
half-written frame), mid-file WAL corruption, a manifest-less generation,
pruning, `attach`'s reuse and refusal, the warm bundle applied and
discarded, the facade's auto-restore, `clear_database` and checkpoints,
no file and no WAL without a snapshot root, and no CPU fallback for a
restore left to its default device."""

import json
import os
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.storage import checkpoint as jx_checkpoint
from das_tpu.storage import durable as jx_durable
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import SnapshotCorruptError
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast, fused
from das_tpu_torch.storage import checkpoint, durable
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.delta import IncrementalCommitMixin
from das_tpu_torch.storage.tensor_db import TensorDB
from tests.test_torch_query import _answer, _build
from tests.test_torch_store import _assert_tables_equal, _jx_tables

BIO = dict(n_genes=30, n_processes=5, members_per_gene=3, n_interactions=30,
           n_evaluations=6)
V1, V2, V3 = ("V", "V1"), ("V", "V2"), ("V", "V3")

#: the same section under each package's encoding
SECTION_NAMES = {"records.msgpack": checkpoint.RECORDS_FILE,
                 "registry.msgpack": checkpoint.REGISTRY_FILE,
                 "indexes.npz": checkpoint.INDEXES_FILE,
                 "warm.msgpack": durable.WARM_FILE}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PALLAS", "DAS_TPU_VMEM_BUDGET",
                "DAS_TPU_STAR", "DAS_TPU_HOST_COUNT", "DAS_TPU_SNAPSHOT_DIR", "DAS_TPU_WAL",
                "DAS_TPU_SNAPSHOT_KEEP", "DAS_TPU_CHECKPOINT"):
        monkeypatch.delenv(var, raising=False)
    durable.reset_stats()


# -- stores, transactions, queries -------------------------------------------


def _data(kb):
    """(JAX data, port data) of the same knowledge base."""
    if kb == "animals":
        return jx_load(jx_animals()), load_metta_text(animals_metta())
    return jx_bio(**BIO)[0], build_bio_atomspace(**BIO)[0]


def _gene_names(data, n):
    """The first n genes of the generated KB (committed genes left out)."""
    return sorted(r.name for r in data.nodes.values()
                  if r.named_type == "Gene" and not r.name.startswith("DURGENE"))[:n]


def _transactions(kb, data):
    """Two transactions of each KB, declaring every node they name."""
    if kb == "animals":
        return [['(: "lion" Concept)', '(: "tiger" Concept)', '(Inheritance "lion" "mammal")',
                 '(Inheritance "tiger" "mammal")', '(Similarity "lion" "tiger")'],
                ['(: "bear" Concept)', '(Inheritance "bear" "mammal")']]
    g0, g1 = _gene_names(data, 2)
    return [[f'(: "DURGENE:{i}" Gene)', f'(: "{g}" Gene)',
             f'(Interacts "DURGENE:{i}" "{g}")', f'(Interacts "{g}" "DURGENE:{i}")']
            for i, g in enumerate((g0, g1))]


def _queries(kb, data):
    if kb == "animals":
        inh = lambda a, b: ("L", "Inheritance", [a, b], True)
        mammal = ("N", "Concept", "mammal")
        return [inh(V1, mammal), ("And", [inh(V1, mammal), inh(V1, V2)]),
                ("And", [inh(V1, V2), ("Not", inh(V1, mammal))])]
    out = []
    for g in _gene_names(data, 2) + ["DURGENE:0"]:
        third = ("L", "Interacts", [("N", "Gene", g), V2], True)
        base = [("L", "Member", [("N", "Gene", g), V3], True), ("L", "Member", [V2, V3], True)]
        out += [("And", base + [third]), ("And", base + [("Not", third)])]
    return out


def _commit(das, lines):
    tx = das.open_transaction()
    for line in lines:
        tx.add(line)
    das.commit_transaction(tx)


def _pair(tmp_path, kb, **cfg):
    """A JAX and a port facade over the same KB, each attached to its own
    snapshot root (generation 1 written at construction)."""
    jd, pd = _data(kb)
    jx = JxDAS(backend="tensor", data=jd,
               config=JxConfig(snapshot_dir=str(tmp_path / "jx"), **cfg))
    pt = DistributedAtomSpace(backend="tensor", data=pd, device="cpu",
                              config=DasConfig(snapshot_dir=str(tmp_path / "pt"), **cfg))
    return jx, pt


def _restored(tmp_path, **cfg):
    """Both facades rebuilt from their snapshot roots alone."""
    jx = JxDAS(backend="tensor", config=JxConfig(snapshot_dir=str(tmp_path / "jx"), **cfg))
    pt = DistributedAtomSpace(backend="tensor", device="cpu",
                              config=DasConfig(snapshot_dir=str(tmp_path / "pt"), **cfg))
    return jx, pt


def _assert_same_store(jx, pt, queries):
    """Tables bit for bit, counters, registries and answers as sets."""
    _assert_tables_equal(_jx_tables(jx.db), pt.db.dev)
    for name in ("delta_version", "_delta_total"):
        assert getattr(pt.db, name) == getattr(jx.db, name), name
    assert pt.count_atoms() == jx.count_atoms()
    assert pt.db.fin.hex_of_row == jx.db.fin.hex_of_row
    for spec in queries:
        assert _answer(pt, _build(ast, spec)) == _answer(jx, _build(jx_ast, spec)), spec


def _gen_dir(das, n=-1):
    return durable.list_generations(das._snapshot_root())[n][1]


def _wal_records(das):
    """The decoded records of a facade's newest WAL, either package."""
    if isinstance(das, JxDAS):
        return jx_durable.read_wal(os.path.join(_gen_dir(das), jx_durable.WAL_FILE),
                                   truncate=False)[0]
    return durable.read_wal(os.path.join(_gen_dir(das), durable.WAL_FILE), truncate=False)[0]


def _read_section(path):
    blob = Path(path).read_bytes()
    if path.endswith(".msgpack"):
        return msgpack.unpackb(blob, raw=False, strict_map_key=False)
    return durable.decode(blob)


def _assert_same_generation(jx_dir, pt_dir):
    """Decoded sections, npz arrays and manifests of two generations (or
    flat checkpoints) equal across the packages."""
    jm = json.loads(Path(jx_dir, jx_durable.MANIFEST_FILE).read_text())
    pm = json.loads(Path(pt_dir, durable.MANIFEST_FILE).read_text())
    assert sorted(SECTION_NAMES[n] for n in jm["sections"]) == sorted(pm["sections"])
    for name in jm["sections"]:
        if name.endswith(".npz"):
            with np.load(os.path.join(jx_dir, name)) as a, \
                    np.load(os.path.join(pt_dir, SECTION_NAMES[name])) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert (_read_section(os.path.join(jx_dir, name))
                    == _read_section(os.path.join(pt_dir, SECTION_NAMES[name]))), name
    for m in (jm, pm):
        for key in ("sections", "created_unix", "xla_cache_dir"):
            m.pop(key, None)
    assert jm == pm


# -- parity with das_tpu ---------------------------------------------------


@pytest.mark.parametrize("kb", ["animals", "bio"])
def test_checkpoint_sections_match_das_tpu(tmp_path, kb):
    """A flat checkpoint of the same store: decoded records and registry,
    npz arrays, manifests and content fingerprints equal; both load back
    to the same store."""
    jd, pd = _data(kb)
    jx_checkpoint.save(jd, str(tmp_path / "jx"))
    checkpoint.save(pd, str(tmp_path / "pt"))
    _assert_same_generation(str(tmp_path / "jx"), str(tmp_path / "pt"))
    assert checkpoint._content_sig(pd.finalize()) == jx_checkpoint._content_sig(jd.finalize())
    back = checkpoint.load(str(tmp_path / "pt"))
    assert back._fin is not None and back._fin.dangling_hexes == set()
    assert back.count_atoms() == pd.count_atoms()
    assert checkpoint._records_payload(back) == checkpoint._records_payload(pd)


#: (kb, what happens between the commits and the restore)
SCENARIOS = [("animals", "commits"), ("bio", "commits"), ("animals", "full"),
             ("bio", "torn_tail"), ("animals", "corrupt_section")]


@pytest.mark.parametrize("kb,scenario", SCENARIOS, ids=["-".join(s) for s in SCENARIOS])
def test_snapshot_commits_restore_match_das_tpu(tmp_path, kb, scenario):
    """Generation 1 at construction, two commits logged, then a restore of
    each package from its root alone: equal generations, equal WAL
    payloads, and restored stores equal bit for bit with equal answers.
    "full": a delta_merge_threshold that makes the first commit a
    rebuild (a kind="full" record); "torn_tail": half a frame appended to
    both WALs (truncated, never replayed); "corrupt_section": a second
    generation at the head, its records section damaged in both roots
    (restore falls back to generation 1 and its WAL)."""
    cfg = {"delta_merge_threshold": 4} if scenario == "full" else {}
    jx, pt = _pair(tmp_path, kb, **cfg)
    queries = _queries(kb, pt.data)
    _assert_same_generation(_gen_dir(jx), _gen_dir(pt))
    for lines in _transactions(kb, pt.data):
        _commit(jx, lines)
        _commit(pt, lines)
    wal = _wal_records(pt)
    assert wal == _wal_records(jx) and len(wal) == 2
    assert [r["kind"] for r in wal] == (["full", "delta"] if scenario == "full"
                                        else ["delta", "delta"])
    assert [r["v"] for r in wal] == [2, 3] and pt.db.delta_version == 3
    _assert_same_store(jx, pt, queries)
    live = {spec_i: _answer(pt, _build(ast, spec)) for spec_i, spec in enumerate(queries)}
    if scenario == "torn_tail":
        clean = os.path.getsize(os.path.join(_gen_dir(pt), durable.WAL_FILE))
        for das, mod in ((jx, jx_durable), (pt, durable)):
            path = os.path.join(_gen_dir(das), mod.WAL_FILE)
            with open(path, "ab") as f:
                f.write(mod._WAL_HEADER.pack(mod.WAL_MAGIC, 1 << 20, 0) + b"half a frame")
    if scenario == "corrupt_section":
        gens = (jx.save_snapshot(), pt.save_snapshot())
        _assert_same_generation(*gens)
        for gen, name in zip(gens, ("records.msgpack", checkpoint.RECORDS_FILE)):
            blob = bytearray(Path(gen, name).read_bytes())
            blob[40:50] = b"\x00" * 10
            Path(gen, name).write_bytes(bytes(blob))
    rjx, rpt = _restored(tmp_path, **cfg)
    assert rpt.db.delta_version == pt.db.delta_version == 3
    assert durable.DUR_STATS["recovery_replayed"] == 2
    if scenario == "torn_tail":
        assert durable.DUR_STATS["torn_tail_truncations"] == 1
        assert os.path.getsize(os.path.join(_gen_dir(pt), durable.WAL_FILE)) == clean
    if scenario == "corrupt_section":
        assert durable.DUR_STATS["corrupt_generations"] == 1
    _assert_same_store(rjx, rpt, queries)
    assert {i: _answer(rpt, _build(ast, s)) for i, s in enumerate(queries)} == live
    if scenario == "commits" and kb == "bio":
        # a snapshot after commits is a fresh finalize (its row order is
        # not the live store's): equal to das_tpu's, and the live store
        # keeps interning into its own fin
        fin = pt.db.fin
        _assert_same_generation(jx.save_snapshot(), pt.save_snapshot())
        assert pt.db.fin is fin and pt.data._fin is not fin
        extra = ['(: "DURGENE:0" Gene)', '(: "DURGENE:9" Gene)',
                 '(Interacts "DURGENE:9" "DURGENE:0")']
        _commit(jx, extra)
        _commit(pt, extra)
        assert pt.db.fin is fin and pt.db._delta_total == jx.db._delta_total > 0
        _assert_same_store(jx, pt, queries)
        rjx, rpt = _restored(tmp_path, **cfg)
        _assert_same_store(rjx, rpt, queries)


def test_warm_bundle_matches_das_tpu(tmp_path):
    """After the same queries and counts on both stores, the decoded warm
    bundles are equal (learned capacities, count-cache entries, planner
    statistics), and each package's bundle applies on its restore."""
    jx, pt = _pair(tmp_path, "bio")
    specs = _queries("bio", pt.data)
    for das, mod in ((jx, jx_ast), (pt, ast)):
        for spec in specs:
            das.query(_build(mod, spec))
        from das_tpu.query import compiler as jx_compiler
        from das_tpu_torch.query import compiler

        comp = jx_compiler if das is jx else compiler
        comp.count_matches(das.db, _build(mod, specs[0]))
    gens = (jx.save_snapshot(), pt.save_snapshot())
    warm = [_read_section(os.path.join(g, n))
            for g, n in zip(gens, ("warm.msgpack", durable.WARM_FILE))]
    assert warm[0] == warm[1]
    assert warm[1]["caps"] and warm[1]["planner"]["rows"]
    rjx, rpt = _restored(tmp_path)
    rex = fused.get_executor(rpt.db)
    assert rex._cap_store._data == warm[1]["caps"]["_cap_store"]


# -- crash points and corruption -----------------------------------------------


def _bio_store(tmp_path, **cfg):
    return DistributedAtomSpace(backend="tensor", data=build_bio_atomspace(**BIO)[0],
                                device="cpu",
                                config=DasConfig(snapshot_dir=str(tmp_path / "root"), **cfg))


def _answers(das):
    return [_answer(das, _build(ast, s)) for s in _queries("bio", das.data)]


@pytest.mark.parametrize("crash_at", [1, 5, 6])
def test_crash_while_snapshotting_keeps_prior_generation(tmp_path, monkeypatch, crash_at):
    """os.replace fails at its n-th call while a second generation is
    written (1: the records section's rename, 5: the manifest's, 6: the
    generation directory's publish): no new generation appears, no
    temporary file or directory is left, and a restore answers as the
    live store."""
    das = _bio_store(tmp_path)
    _commit(das, _transactions("bio", das.data)[0])
    live = _answers(das)
    calls = []
    replace = os.replace

    def failing(src, dst):
        calls.append(dst)
        if len(calls) == crash_at:
            raise OSError("crash")
        return replace(src, dst)

    monkeypatch.setattr(durable.os, "replace", failing)
    with pytest.raises(OSError, match="crash"):
        das.save_snapshot()
    monkeypatch.setattr(durable.os, "replace", replace)
    root = das._snapshot_root()
    assert [n for n, _ in durable.list_generations(root)] == [1]
    assert os.listdir(root) == ["gen-000001"]
    assert sorted(os.listdir(_gen_dir(das))) == sorted(
        [checkpoint.RECORDS_FILE, checkpoint.INDEXES_FILE, checkpoint.REGISTRY_FILE,
         durable.WARM_FILE, durable.MANIFEST_FILE, durable.WAL_FILE])
    back = DistributedAtomSpace(backend="tensor", device="cpu",
                                config=DasConfig(snapshot_dir=str(tmp_path / "root")))
    assert _answers(back) == live and back.db.delta_version == das.db.delta_version


def test_half_written_frame_fails_the_commit_and_is_truncated(tmp_path, monkeypatch):
    """A crash inside DeltaLog.append after half a frame reached the file:
    the commit raises before any swap (delta_version, tables and answers
    as before), and a restore truncates the torn tail and never replays
    it; the truncated log then takes the next commit."""
    das = _bio_store(tmp_path)
    tx1, tx2 = _transactions("bio", das.data)
    _commit(das, tx1)
    before, version = _answers(das), das.db.delta_version
    bucket = das.db.dev.buckets[2]
    append = durable.DeltaLog.append

    def torn_append(log, data, v, kind="delta"):
        fragment, _sizes = log._capture(data)
        payload = durable.encode(dict(fragment, v=v, kind=kind))
        frame = durable._WAL_HEADER.pack(durable.WAL_MAGIC, len(payload),
                                         durable.zlib.crc32(payload)) + payload
        with open(log.path, "ab") as f:
            f.write(frame[:len(frame) // 2])
        raise OSError("crash mid-append")

    monkeypatch.setattr(durable.DeltaLog, "append", torn_append)
    with pytest.raises(OSError, match="mid-append"):
        _commit(das, tx2)
    monkeypatch.setattr(durable.DeltaLog, "append", append)
    assert das.db.delta_version == version and das.db.dev.buckets[2] is bucket
    path = os.path.join(_gen_dir(das), durable.WAL_FILE)
    records, torn = durable.read_wal(path, truncate=False)
    assert torn and len(records) == 1
    back = DistributedAtomSpace(backend="tensor", device="cpu",
                                config=DasConfig(snapshot_dir=str(tmp_path / "root")))
    assert durable.DUR_STATS["torn_tail_truncations"] == 1
    assert back.db.delta_version == version and _answers(back) == before
    assert durable.read_wal(path) == (records, False)
    _commit(back, tx2)
    again = DistributedAtomSpace(backend="tensor", device="cpu",
                                 config=DasConfig(snapshot_dir=str(tmp_path / "root")))
    assert again.db.delta_version == version + 1 and _answers(again) == _answers(back)


def test_midfile_wal_corruption_raises_and_keeps_the_file(tmp_path):
    das = _bio_store(tmp_path)
    for lines in _transactions("bio", das.data):
        _commit(das, lines)
    path = os.path.join(_gen_dir(das), durable.WAL_FILE)
    blob = bytearray(Path(path).read_bytes())
    blob[durable._WAL_HEADER.size + 2:durable._WAL_HEADER.size + 4] = b"\xde\xad"
    Path(path).write_bytes(bytes(blob))
    with pytest.raises(SnapshotCorruptError, match="refusing to truncate"):
        durable.read_wal(path)
    assert Path(path).read_bytes() == bytes(blob)
    with pytest.raises(SnapshotCorruptError):
        TensorDB.restore(das._snapshot_root(), device="cpu")


def test_wal_continuity_gap_raises(tmp_path):
    das = _bio_store(tmp_path)
    for lines in _transactions("bio", das.data):
        _commit(das, lines)
    path = os.path.join(_gen_dir(das), durable.WAL_FILE)
    records, _ = durable.read_wal(path)
    Path(path).unlink()
    rec = records[1]
    payload = durable.encode(rec)      # v3 with v2 missing
    Path(path).write_bytes(durable._WAL_HEADER.pack(
        durable.WAL_MAGIC, len(payload), durable.zlib.crc32(payload)) + payload)
    with pytest.raises(SnapshotCorruptError, match="continuity"):
        TensorDB.restore(das._snapshot_root(), device="cpu")


def test_generations_manifest_less_pruned_and_all_corrupt(tmp_path):
    """A generation with no manifest is a torn write (the prior one
    loads); pruning keeps `snapshot_keep`; with every generation corrupt
    the restore raises."""
    das = _bio_store(tmp_path, snapshot_keep=3)
    root = das._snapshot_root()
    for _ in range(3):
        das.save_snapshot()
    assert [n for n, _ in durable.list_generations(root)] == [2, 3, 4]
    os.remove(os.path.join(_gen_dir(das), durable.MANIFEST_FILE))
    _data, manifest, gen_dir = durable.newest_valid_generation(root)
    assert manifest["generation"] == 3 and gen_dir == _gen_dir(das, -2)
    for _n, gen in durable.list_generations(root)[:-1]:
        p = Path(gen, checkpoint.REGISTRY_FILE)
        p.write_bytes(p.read_bytes()[:-1] + b" ")
    durable.reset_stats()
    with pytest.raises(SnapshotCorruptError, match="no valid snapshot generation"):
        TensorDB.restore(root, device="cpu")
    assert durable.DUR_STATS["corrupt_generations"] == 3


def test_attach_reuses_only_a_generation_describing_the_store(tmp_path):
    """attach reuses the newest generation when it matches the store's
    delta_version and content and its WAL is empty; a foreign store, or a
    generation whose WAL moved on, gets a fresh generation."""
    root = str(tmp_path / "root")
    a = TensorDB(build_bio_atomspace(**BIO)[0], DasConfig(), device="cpu")
    gen1 = durable.attach(a, root)
    assert gen1.endswith("gen-000001") and a._wal is not None
    twin = TensorDB(build_bio_atomspace(**BIO)[0], DasConfig(), device="cpu")
    assert durable.attach(twin, root) == gen1
    other = TensorDB(build_bio_atomspace(**dict(BIO, n_genes=12))[0], DasConfig(),
                     device="cpu")
    assert durable.attach(other, root).endswith("gen-000002")
    das = DistributedAtomSpace(backend="tensor", device="cpu", data=other.data,
                               config=DasConfig(snapshot_dir=str(tmp_path / "other")))
    _commit(das, _transactions("bio", das.data)[0])
    moved_on = _gen_dir(das)
    fresh = TensorDB(checkpoint.load(moved_on, _verified=True), DasConfig(), device="cpu")
    assert durable.attach(fresh, das._snapshot_root()) != moved_on


# -- the warm bundle -----------------------------------------------------------


def _fanout(mod, proc):
    return mod.And([mod.Link("Member", [mod.Variable("G"), mod.Node("BiologicalProcess", proc)],
                             True),
                    mod.Link("Member", [mod.Variable("G"), mod.Variable("P2")], True)])


def test_warm_bundle_applied_and_discarded(tmp_path, monkeypatch):
    """With the planner off the greedy seed misses the fan-out query's
    capacity: the live store pays a retry round.  Restored at the
    snapshot's version the bundle applies and the first pass takes one
    round; restored past it (a WAL commit) the bundle is discarded and
    the retry comes back; a store built from the same records without the
    bundle pays it too."""
    data = build_bio_atomspace(n_genes=32, n_processes=100, members_per_gene=50,
                               n_interactions=0, seed=3)[0]
    cfg = lambda: DasConfig(use_planner="off", snapshot_dir=str(tmp_path / "root"))
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu", config=cfg())
    proc = sorted(r.name for r in data.nodes.values()
                  if r.named_type == "BiologicalProcess")[0]
    q = _fanout(ast, proc)
    runs = []
    run_conj = fused.run_conj

    def counted(*a, **kw):
        runs.append(1)
        return run_conj(*a, **kw)

    monkeypatch.setattr(fused, "run_conj", counted)

    def rounds(d):
        runs.clear()
        got = d.query(q)
        return len(runs), got

    cold, answer = rounds(das)
    assert cold >= 2
    gen = das.save_snapshot()
    warm = durable.decode(Path(gen, durable.WARM_FILE).read_bytes())
    assert warm["delta_version"] == das.db.delta_version and warm["caps"]["_cap_store"]
    restored = DistributedAtomSpace(backend="tensor", device="cpu", config=cfg())
    assert rounds(restored) == (1, answer)
    no_bundle = DistributedAtomSpace(backend="tensor", device="cpu", config=DasConfig(
        use_planner="off"), data=checkpoint.load(gen, _verified=True))
    assert rounds(no_bundle) == (cold, answer)
    # a commit past the snapshot: the bundle is stale and discarded
    _commit(restored, ['(: "G:new" Gene)', f'(: "{proc}" BiologicalProcess)',
                       f'(Member "G:new" "{proc}")'])
    stale = DistributedAtomSpace(backend="tensor", device="cpu", config=cfg())
    assert stale.db.delta_version == restored.db.delta_version
    assert not fused.get_executor(stale.db)._cap_store._data
    assert rounds(stale)[0] >= 2
    # the pure function both ways
    state = {"delta_version": stale.db.delta_version + 1, "caps": {}}
    assert fused.apply_warm_state(stale.db, state) is False
    state = {"delta_version": stale.db.delta_version,
             "caps": {"_cap_store": {"k": [[1], [2]]}}, "counts": [], "planner": {}}
    assert fused.apply_warm_state(stale.db, state) is True
    assert fused.get_executor(stale.db)._cap_store._data["k"] == [[1], [2]]


def test_cap_store_dir_persists_learned_caps(tmp_path):
    """With cap_store_dir set, learned capacities are written there and a
    new executor of a same-sized store reads them; with None nothing is
    written and no hashed copy is kept, yet the warm bundle hashes the
    same entries."""
    data = build_bio_atomspace(**BIO)[0]
    cfg = DasConfig(cap_store_dir=str(tmp_path / "caps"))
    das = DistributedAtomSpace(backend="tensor", data=data, device="cpu", config=cfg)
    das.query(_build(ast, _queries("bio", data)[0]))
    path = tmp_path / "caps" / "caps_greedy.json"
    saved = json.loads(path.read_text())
    assert saved
    other = DistributedAtomSpace(backend="tensor", data=build_bio_atomspace(**BIO)[0],
                                 device="cpu", config=cfg)
    assert fused.get_executor(other.db)._cap_store._data == saved
    assert fused.CapStore("greedy").path is None
    plain = DistributedAtomSpace(backend="tensor", data=build_bio_atomspace(**BIO)[0],
                                 device="cpu")
    plain.query(_build(ast, _queries("bio", plain.data)[0]))
    ex = fused.get_executor(plain.db)
    assert ex._caps and not ex._cap_store._data
    assert fused.export_warm_state(plain.db)["caps"]["_cap_store"] == saved


# -- the facade ----------------------------------------------------------------


def test_facade_checkpoints_snapshots_and_clear(tmp_path):
    """save_checkpoint / load_checkpoint (flat), checkpoint_path at
    construction, a generational checkpoint load that includes the WAL's
    commits, restore_snapshot, and clear_database writing a new
    generation."""
    das = _bio_store(tmp_path)
    tx1, tx2 = _transactions("bio", das.data)
    _commit(das, tx1)
    flat = str(tmp_path / "flat")
    das.save_checkpoint(flat)
    _commit(das, tx2)
    live = _answers(das)
    loaded = DistributedAtomSpace(backend="tensor", device="cpu",
                                  config=DasConfig(checkpoint_path=flat))
    assert loaded.count_atoms()[1] == das.count_atoms()[1] - 2
    loaded.load_checkpoint(das._snapshot_root())     # generation 1 + 2 WAL commits
    assert loaded.count_atoms() == das.count_atoms() and _answers(loaded) == live
    from_root = DistributedAtomSpace(backend="tensor", device="cpu",
                                     config=DasConfig(checkpoint_path=das._snapshot_root()))
    assert _answers(from_root) == live
    other = DistributedAtomSpace(backend="tensor", device="cpu",
                                 data=build_bio_atomspace(**dict(BIO, n_genes=12))[0])
    other.restore_snapshot(das._snapshot_root())
    assert other.db.delta_version == 3 and _answers(other) == live
    das.clear_database()
    assert das.count_atoms() == (0, 0) and das.db._wal is not None
    assert [n for n, _ in durable.list_generations(das._snapshot_root())] == [1, 2]
    empty = DistributedAtomSpace(backend="tensor", device="cpu",
                                 config=DasConfig(snapshot_dir=str(tmp_path / "root")))
    assert empty.count_atoms() == (0, 0)
    named = DistributedAtomSpace(backend="tensor", device="cpu", database_name="b",
                                 config=DasConfig(snapshot_dir=str(tmp_path / "root")))
    assert named._snapshot_root() == str(tmp_path / "root" / "b")
    assert durable.list_generations(named._snapshot_root())
    with pytest.raises(ValueError, match="no snapshot root"):
        DistributedAtomSpace(backend="tensor", device="cpu").save_snapshot()


def test_no_snapshot_root_writes_nothing(tmp_path, monkeypatch):
    """Without snapshot_dir the commit path has no WAL (the class
    attribute None), never appends, and no file is written."""
    assert IncrementalCommitMixin._wal is None
    monkeypatch.chdir(tmp_path)

    def refuse(*a, **kw):
        raise AssertionError("a durable write without a snapshot root")

    monkeypatch.setattr(durable.DeltaLog, "append", refuse)
    monkeypatch.setattr(durable, "atomic_write", refuse)
    das = DistributedAtomSpace(backend="tensor", device="cpu",
                               data=build_bio_atomspace(**BIO)[0])
    for lines in _transactions("bio", das.data):
        _commit(das, lines)
    assert das.db._wal is None and "_wal" not in vars(das.db)
    assert das.db.delta_version == 3 and not os.listdir(tmp_path)


def test_payload_codec_and_default_device(tmp_path):
    """The codec refuses int keys and bytes; a restore left to its
    default device raises without a card, through TensorDB.restore and
    the facade alike."""
    blob = durable.encode({"a": (1, [2, None], True)})
    assert durable.decode(blob) == {"a": [1, [2, None], True]}
    with pytest.raises(TypeError):
        durable.encode({"a": {1: "x"}})
    with pytest.raises(TypeError):
        durable.encode({"a": b"x"})
    das = _bio_store(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorDB.restore(das._snapshot_root())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedAtomSpace(backend="tensor",
                             config=DasConfig(snapshot_dir=str(tmp_path / "root")))
