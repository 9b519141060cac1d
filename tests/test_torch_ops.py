"""The port's plain PyTorch ops (das_tpu_torch/ops/) against the JAX
package's lowered ops (das_tpu/ops/): the same seeded numpy inputs through
both, outputs compared bit for bit — values, masks, exact totals —
including total > capacity, tied keys, sentinel rows and empty sides."""

import jax
import numpy as np
import pytest
import torch

from das_tpu.ops import join as jx_join
from das_tpu.ops import posting as jx_posting
from das_tpu_torch.ops import join as pt_join
from das_tpu_torch.ops import posting as pt_posting


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _same(a, b):
    """Bit-equality of a JAX output and a torch output, dtype included."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _table(rng, n, k, span, p_valid=0.8):
    vals = rng.integers(0, span, (n, k)).astype(np.int32)
    valid = rng.random(n) < p_valid
    vals[~valid] = 0
    return vals, valid


def test_mix_columns_bitwise():
    rng = np.random.default_rng(0)
    vals = rng.integers(-2**31, 2**31 - 1, (64, 3), dtype=np.int64).astype(np.int32)
    valid = rng.random(64) < 0.7
    for cols in [(0,), (2, 0), (0, 1, 2), ()]:
        want = jx_join._mix_columns(vals, cols, valid, jx_join._SENTINEL_L)
        got = pt_join.mix_columns(_t(vals), cols, _t(valid), pt_join.SENTINEL_L)
        _same(want, got)


#: (L, kl, R, kr, pairs, right_extra, capacity, key span, p_valid)
JOIN_CASES = [
    (24, 2, 30, 2, ((0, 0),), (1,), 64, 5, 0.8),        # ties, total > cap
    (24, 2, 30, 2, ((0, 0),), (1,), 4096, 5, 0.8),      # everything fits
    (16, 3, 12, 3, ((0, 1), (2, 0)), (2,), 128, 3, 0.9),  # two shared columns
    (8, 1, 6, 2, (), (0, 1), 64, 4, 1.0),               # cross product
    (10, 2, 12, 2, ((1, 0),), (1,), 32, 4, 0.0),        # all-invalid left
]


@pytest.mark.parametrize("case", JOIN_CASES)
def test_join_tables_bitwise(case):
    n_l, kl, n_r, kr, pairs, extra, cap, span, p = case
    rng = np.random.default_rng(n_l * 31 + n_r)
    lv, lm = _table(rng, n_l, kl, span, p)
    rv, rm = _table(rng, n_r, kr, span, 0.8)
    want = jx_join.join_tables(lv, lm, rv, rm, pairs, extra, cap)
    got = pt_join.join_tables(_t(lv), _t(lm), _t(rv), _t(rm), pairs, extra, cap)
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("n_l,n_r", [(0, 10), (10, 0)])
def test_join_tables_empty_side(n_l, n_r):
    """The JAX lowered join cannot gather from a zero-row side; the port
    (like the kernel contract) answers an empty side with total 0 and every
    slot zeroed."""
    rng = np.random.default_rng(n_l + 7 * n_r)
    lv, lm = _table(rng, n_l, 2, 4)
    rv, rm = _table(rng, n_r, 2, 4)
    out, ov, total = pt_join.join_tables(_t(lv), _t(lm), _t(rv), _t(rm), ((0, 0),), (1,), 32)
    assert out.dtype == torch.int32 and out.shape == (32, 3) and not out.any()
    assert ov.dtype == torch.bool and not ov.any()
    assert total.dtype == torch.int64 and int(total) == 0


def _index_inputs(rng, m, arity, type_key, span):
    targets = rng.integers(0, span, (m, arity)).astype(np.int32)
    keyarr = (np.int64(type_key) << 32) | targets[:, 0].astype(np.int64)
    # another type's keys interleave, as in a real (type<<32|target) index
    other = (np.int64(type_key + 1) << 32) | np.arange(4, dtype=np.int64)
    keys = np.concatenate([keyarr, other])
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    perm = np.where(perm >= m, 0, perm).astype(np.int32)
    return np.sort(keys, kind="stable"), perm, targets


_jx_index_join = jax.jit(
    jx_join._index_join_impl,
    static_argnames=("pairs", "right_var_cols", "right_extra", "capacity"),
)


@pytest.mark.parametrize("pairs,extra,cap", [
    (((0, 0),), (1,), 32),          # total > cap
    (((0, 0),), (1,), 1024),
    (((1, 0), (0, 1)), (), 256),    # second pair verified on the targets
])
def test_index_join_bitwise(pairs, extra, cap):
    rng = np.random.default_rng(cap)
    keys, perm, targets = _index_inputs(rng, 60, 2, 3, 7)
    lv, lm = _table(rng, 20, 2, 7)
    want = _jx_index_join(lv, lm, keys, perm, targets, np.int64(3), pairs=pairs,
                          right_var_cols=(0, 1), right_extra=extra, capacity=cap)
    got = pt_join.index_join(_t(lv), _t(lm), _t(keys), _t(perm), _t(targets), 3,
                             pairs, (0, 1), extra, cap)
    for w, g in zip(want, got):
        _same(w, g)


def test_index_join_all_invalid_left():
    rng = np.random.default_rng(5)
    keys, perm, targets = _index_inputs(rng, 30, 2, 3, 5)
    lv, lm = _table(rng, 12, 2, 5, 0.0)
    want = _jx_index_join(lv, lm, keys, perm, targets, np.int64(3), pairs=((0, 0),),
                          right_var_cols=(0, 1), right_extra=(1,), capacity=16)
    got = pt_join.index_join(_t(lv), _t(lm), _t(keys), _t(perm), _t(targets), 3,
                             ((0, 0),), (0, 1), (1,), 16)
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("n_r,p_valid", [(40, 0.8), (0, 0.8), (40, 0.0)])
def test_anti_join_bitwise(n_r, p_valid):
    rng = np.random.default_rng(n_r + int(10 * p_valid))
    lv, lm = _table(rng, 50, 2, 4)
    rv, rm = _table(rng, n_r, 2, 4, p_valid)
    for pairs in [((0, 0),), ((0, 1), (1, 0))]:
        want = jx_join.anti_join(lv, lm, rv, rm, pairs)
        got = pt_join.anti_join(_t(lv), _t(lm), _t(rv), _t(rm), pairs)
        _same(want, got)


def test_build_term_table_and_dedup_bitwise():
    rng = np.random.default_rng(9)
    targets = rng.integers(0, 5, (40, 3)).astype(np.int32)
    local = rng.integers(0, 40, 32).astype(np.int32)
    local[-4:] = 2**31 - 1
    mask = rng.random(32) < 0.8
    for var_cols, eq in [((0, 2), ()), ((1, 2), ((0, 2),))]:
        want = jx_join.build_term_table(targets, local, mask, var_cols, eq)
        got = pt_join.build_term_table(_t(targets), _t(local), _t(mask), var_cols, eq)
        for w, g in zip(want, got):
            _same(w, g)
        want = jx_join.dedup_table(*want)
        got = pt_join.dedup_table(*got)
        for w, g in zip(want, got):
            _same(w, g)


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_range_probe_verify_dedup_bitwise(key_dtype):
    rng = np.random.default_rng(3)
    n = 50
    keys = np.sort(rng.integers(0, 6, n)).astype(key_dtype)
    keys[-5:] = np.iinfo(key_dtype).max  # capacity padding
    perm = rng.permutation(n).astype(np.int32)
    targets = rng.integers(0, 4, (n, 2)).astype(np.int32)
    type_id = rng.integers(0, 2, n).astype(np.int32)
    for key, cap in [(2, 4), (2, 64), (9, 16)]:  # total > cap, fits, absent
        want = jx_posting.range_probe(keys, perm, key_dtype(key), cap)
        got = pt_posting.range_probe(_t(keys), _t(perm), key, cap)
        for w, g in zip(want, got):
            _same(w, g)
        local, valid = got[0], got[1]
        for probe_type, fixed in [(-1, ((1, 2),)), (1, ())]:
            want_m = jx_posting.verify_positions(
                targets, type_id, want[0], want[1], np.int32(probe_type), fixed)
            got_m = pt_posting.verify_positions(
                _t(targets), _t(type_id), local, valid, probe_type, fixed)
            _same(want_m, got_m)
        for w, g in zip(jx_posting.dedup_sorted(want[0], want[1]),
                        pt_posting.dedup_sorted(local, valid)):
            _same(w, g)


def test_probe_empty_key_column():
    """n_keys == 0 (the JAX lowered probe cannot gather from it): count 0,
    every slot invalid and parked on INVALID_ROW."""
    local, valid, count = pt_posting.range_probe(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int32), 3, 8)
    assert count.dtype == torch.int32 and int(count) == 0
    assert not valid.any()
    assert (local == pt_posting.INVALID_ROW).all()


def test_stable_tie_order_is_pinned():
    """torch.argsort defaults to an unstable sort; the join must not: with
    every right key tied, slot j pairs with right row j in input order."""
    lv = np.array([[7]], np.int32)
    rv = np.stack([np.full(300, 7), np.arange(300)], axis=1).astype(np.int32)
    out, ov, total = pt_join.join_tables(
        _t(lv), torch.ones(1, dtype=torch.bool), _t(rv), torch.ones(300, dtype=torch.bool),
        ((0, 0),), (1,), 512)
    assert int(total) == 300
    assert torch.equal(out[:300, 1], torch.arange(300, dtype=torch.int32))
    want = jx_join.join_tables(lv, np.ones(1, bool), rv, np.ones(300, bool),
                               ((0, 0),), (1,), 512)
    _same(want[0], out)

