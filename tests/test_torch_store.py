"""The port's device store (das_tpu_torch/storage/tensor_db.py) against
the JAX package's: on the animals KB and on the SMALL bio configuration of
bench.py, every padded column and posting index of the port's
`DeviceTables` equals the host copy of `das_tpu`'s `TensorDB.dev`, array
by array and dtype by dtype — built from the port's own host store, and
carried across with `device_tables_from_numpy`."""

import jax
import numpy as np
import pytest
import torch

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.carry import device_tables_from_numpy
from das_tpu_torch.storage.tensor_db import (
    BUCKET_LIST_PADS,
    BUCKET_PADS,
    TensorDB,
    capacity_class,
)

#: bench.py SMALL
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5,
             n_interactions=300, n_evaluations=0)


def _jx_tables(db):
    """The plain-numpy form of a das_tpu TensorDB.dev (its host copy)."""
    dev = db.dev
    out = {name: np.asarray(jax.device_get(getattr(dev, name)))
           for name in ("node_type_id", "incoming_offsets", "incoming_links")}
    out["buckets"] = {}
    for arity, b in dev.buckets.items():
        fields = {name: np.asarray(jax.device_get(getattr(b, name))) for name, _ in BUCKET_PADS}
        for name, _ in BUCKET_LIST_PADS:
            fields[name] = [np.asarray(x) for x in jax.device_get(getattr(b, name))]
        fields["size"] = b.size
        out["buckets"][arity] = fields
    return out


def _assert_tables_equal(want, got):
    for name in ("node_type_id", "incoming_offsets", "incoming_links"):
        _same(want[name], getattr(got, name))
    assert sorted(want["buckets"]) == sorted(got.buckets)
    for arity, wb in want["buckets"].items():
        gb = got.buckets[arity]
        assert (gb.arity, gb.size, gb.capacity) == (arity, wb["size"], wb["rows"].shape[0])
        for name, _ in BUCKET_PADS:
            _same(wb[name], getattr(gb, name))
        for name, _ in BUCKET_LIST_PADS:
            assert len(wb[name]) == len(getattr(gb, name))
            for w, g in zip(wb[name], getattr(gb, name)):
                _same(w, g)


def _same(a, t):
    b = t.cpu().numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.fixture(scope="module", params=["animals", "small_bio"])
def both_stores(request):
    if request.param == "animals":
        jx = JxTensorDB(jx_load(jx_animals()), JxConfig())
        pt = TensorDB(load_metta_text(animals_metta()), device="cpu")
    else:
        jx = JxTensorDB(jx_bio(seed=7, **SMALL)[0], JxConfig())
        pt = TensorDB(build_bio_atomspace(seed=7, **SMALL)[0], device="cpu")
    return _jx_tables(jx), pt


def test_device_tables_equal_jax_store(both_stores):
    want, pt = both_stores
    _assert_tables_equal(want, pt.dev)


def test_device_tables_from_numpy_reproduces(both_stores):
    want, pt = both_stores
    _assert_tables_equal(want, device_tables_from_numpy(want, device="cpu"))


def test_padding_and_dtypes(both_stores):
    _want, pt = both_stores
    for b in pt.dev.buckets.values():
        assert b.capacity == capacity_class(b.size) and b.capacity > b.size
        assert b.key_type.dtype == torch.int32
        assert b.key_ctype.dtype == torch.int64
        assert all(k.dtype == torch.int64 for k in b.key_type_pos + b.key_type_spos)
        pad = slice(b.size, None)
        assert (b.key_type[pad] == torch.iinfo(torch.int32).max).all()
        assert (b.key_type_pos[0][pad] == torch.iinfo(torch.int64).max).all()
        assert (b.targets[pad] == -2).all() and (b.targets_sorted[pad] == -2).all()
        assert (b.rows[pad] == -1).all() and (b.type_id[pad] == -1).all()
        assert (b.order_by_type[pad] == 0).all()


def test_no_card_no_default_device():
    """An entry point left to its default device (CUDA) raises without a
    card instead of moving quietly to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorDB(load_metta_text(animals_metta()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_tables_from_numpy({"buckets": {}})
