"""The port's mesh (das_tpu_torch/parallel/mesh.py, 8 shards on
device="cpu") against the JAX package's (das_tpu/parallel/, 8 virtual CPU
devices, tests/conftest.py):

  * the four collectives against jax.lax under shard_map, bit for bit;
  * the hash-partition exchange (`_repartition`) with an exchange small
    enough to drop rows, and with invalid rows, bit for bit;
  * the slabs of `_build_sharded_bucket` against das_tpu's stacked arrays,
    on animals and a small bio store;
  * make_mesh's placement and its error without enough cards;
  * COLLECTIVE_SITES: exactly the scopes of das_tpu_torch/parallel/ that
    call a collective."""

import ast as pyast
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.ops.join import _SENTINEL_L
from das_tpu.parallel import fused_sharded as jx_fs
from das_tpu.parallel import mesh as jx_mesh
from das_tpu.parallel.sharded_db import ShardedDB as JxShardedDB
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.ops.join import SENTINEL_L
from das_tpu_torch.parallel import fused_sharded as fs
from das_tpu_torch.parallel import mesh as M
from das_tpu_torch.parallel.sharded_db import ShardedDB
from das_tpu_torch.storage.atom_table import load_metta_text

S = 8
BIO = dict(n_genes=40, n_processes=10, members_per_gene=3, n_interactions=50, seed=5)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= S, "conftest must provide 8 virtual devices"
    return jx_mesh.make_mesh(S), M.make_mesh(S, device="cpu")


def _shards(x):
    return [torch.from_numpy(np.ascontiguousarray(b)) for b in x]


def _smap(mesh, fn, n_in, out_specs):
    spec = P(jx_mesh.SHARD_AXIS)
    return jax.jit(jx_mesh.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                                     out_specs=out_specs))


def test_all_gather_psum_pmax_match_lax(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, size=(S, 5, 3), dtype=np.int32)
    c = rng.integers(0, 1000, size=(S,), dtype=np.int32)
    axis = jx_mesh.SHARD_AXIS
    gathered = _smap(jm, lambda b: jax.lax.all_gather(b[0], axis, tiled=True)[None], 1,
                     P(axis))(x)
    got = M.all_gather(_shards(x), pm)
    for s in range(S):
        assert np.array_equal(np.asarray(gathered[s]), got[s].numpy())
    total = _smap(jm, lambda b: jax.lax.psum(b, axis), 1, P())(c)
    peak = _smap(jm, lambda b: jax.lax.pmax(b, axis), 1, P())(c)
    assert int(M.psum(_shards(c), pm)) == int(np.asarray(total)[0])
    assert int(M.pmax(_shards(c), pm)) == int(np.asarray(peak)[0])


def test_all_to_all_matches_lax(meshes):
    jm, pm = meshes
    rng = np.random.default_rng(4)
    q = 3
    bufs = rng.integers(0, 100, size=(S, S, q, 2), dtype=np.int32)
    axis = jx_mesh.SHARD_AXIS
    fn = _smap(jm, lambda b: jax.lax.all_to_all(b[0], axis, split_axis=0,
                                                concat_axis=0).reshape(1, S * q, 2), 1, P(axis))
    want = np.asarray(fn(bufs))
    got = M.all_to_all(_shards(bufs), pm)
    for d in range(S):
        assert np.array_equal(want[d], got[d].numpy())
        # row s*q + slot of shard d is what shard s put in slot `slot` for d
        assert np.array_equal(got[d].numpy()[2 * q + 1], bufs[2, d, 1])


@pytest.mark.parametrize("q", [2, 4, 64])
def test_repartition_matches_das_tpu(meshes, q):
    """q=2 drops overflow rows, q=64 drops none; a third of the rows are
    invalid (they must be dropped, not exchanged)."""
    jm, pm = meshes
    rng = np.random.default_rng(q)
    n, k = 24, 2
    vals = rng.integers(0, 40, size=(S, n, k), dtype=np.int32)
    valid = rng.random((S, n)) < 0.66
    cols = (0, 1)
    axis = jx_mesh.SHARD_AXIS

    def body(v, m):
        rv, rm, occ = jx_fs._repartition(v[0], m[0], cols, _SENTINEL_L, S, q)
        return rv[None], rm[None], occ[None]

    spec = P(axis)
    jfn = jax.jit(jx_mesh.shard_map(body, mesh=jm, in_specs=(spec, spec),
                                    out_specs=(spec, spec, spec)))
    jv, jmask, jocc = (np.asarray(a) for a in jfn(vals, valid))
    pv, pmask, pocc = fs._repartition(_shards(vals), _shards(valid), cols, SENTINEL_L, pm, q)
    for d in range(S):
        assert np.array_equal(jv[d], pv[d].numpy())
        assert np.array_equal(jmask[d], pmask[d].numpy())
        assert int(jocc[d]) == int(pocc[d])
    if q == 2:
        assert max(int(o) for o in pocc) > q   # this case really drops rows
    assert sum(int(m.sum()) for m in pmask) <= int(valid.sum())


def _slabs_equal(jdb, pdb):
    assert sorted(jdb.tables.buckets) == sorted(pdb.tables.buckets)
    for arity, jb in jdb.tables.buckets.items():
        pb = pdb.tables.buckets[arity]
        assert (pb.m_local, pb.size) == (jb.m_local, jb.size)
        assert np.array_equal(pb.slab_sizes, jb.slab_sizes)
        host = pb.host()
        for name, arr in host.items():
            base = name.rstrip("0123456789")
            want = getattr(jb, base)
            if base != name:
                want = want[int(name[len(base):])]
            assert np.array_equal(np.asarray(want), arr), (arity, name)


def test_slabs_equal_das_tpu_animals(meshes):
    jm, _ = meshes
    jdb = JxShardedDB(jx_load(jx_animals()), JxConfig(), mesh=jm)
    pdb = ShardedDB(load_metta_text(animals_metta()), DasConfig(mesh_shape=(S,)), device="cpu")
    _slabs_equal(jdb, pdb)
    assert pdb.mesh.devices == (torch.device("cpu"),) * S


def test_slabs_equal_das_tpu_bio(meshes):
    jm, _ = meshes
    jdata, _, _ = jx_bio(**BIO)
    pdata, _, _ = build_bio_atomspace(**BIO)
    _slabs_equal(JxShardedDB(jdata, JxConfig(), mesh=jm),
                 ShardedDB(pdata, DasConfig(mesh_shape=(S,)), device="cpu"))


def test_make_mesh_placement_and_errors(monkeypatch):
    cpu = M.make_mesh(4, device="cpu")
    assert cpu.size == 4 and M.replicated(cpu) == torch.device("cpu")
    assert M.row_sharding(cpu) == (torch.device("cpu"),) * 4
    assert M.make_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.make_mesh(2)
    # one card at hand, eight shards asked for: the JAX package's error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Requested 8 devices, only 1 available"):
        M.make_mesh(8)
    assert M.make_mesh(1).devices == (torch.device("cuda", 0),)


def _collective_scopes():
    """module.qualname of every function of das_tpu_torch/parallel/ that
    calls a collective of mesh.py (through the module alias `M`)."""
    root = os.path.join(os.path.dirname(M.__file__))
    found = set()
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".py") or fname == "mesh.py":
            continue
        tree = pyast.parse(open(os.path.join(root, fname)).read())

        def walk(node, prefix):
            # prefix: the enclosing classes and the outermost function
            in_function = bool(prefix) and prefix[-1][1]
            for child in pyast.iter_child_nodes(node):
                if isinstance(child, (pyast.FunctionDef, pyast.ClassDef)) and not in_function:
                    walk(child, prefix + [(child.name, isinstance(child, pyast.FunctionDef))])
                    continue
                if (isinstance(child, pyast.Call) and isinstance(child.func, pyast.Attribute)
                        and isinstance(child.func.value, pyast.Name)
                        and child.func.value.id == "M"
                        and child.func.attr in ("all_gather", "all_to_all", "psum", "pmax")):
                    found.add(".".join([fname[:-3], *(n for n, _ in prefix)]))
                walk(child, prefix)

        walk(tree, [])
    return found


def test_collective_sites_pinned():
    assert _collective_scopes() == set(M.COLLECTIVE_SITES)
