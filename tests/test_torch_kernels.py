"""The port's kernel wrappers (das_tpu_torch/kernels/) against the JAX
package's TPU kernels.

On the CPU each wrapper takes its plain PyTorch version; here that is held
bit for bit against `das_tpu.kernels.*_impl(..., interpret=True)` — the
direct-discharge route the JAX package's own kernel tests use — in both
the single-block and the grid-chunked layout (forced through the JAX
bytes planner's DAS_TPU_VMEM_BUDGET).  The same wrappers on the card are
held against these plain versions by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from das_tpu.kernels import budget
from das_tpu.kernels.join import anti_join_impl, index_join_impl, join_tables_impl
from das_tpu.kernels.probe import probe_term_table_impl
from das_tpu_torch import kernels
from das_tpu_torch.ops.join import SENTINEL_L, SENTINEL_R, mix_columns

#: budget under which the shapes below take the grid-chunked layout
#: (3 chunks of 1024 rows); unset = the default budget's single block
LAYOUTS = {"single": None, "tiled": "80000"}


@pytest.fixture(params=sorted(LAYOUTS))
def layout(request, monkeypatch):
    if LAYOUTS[request.param] is None:
        monkeypatch.delenv("DAS_TPU_VMEM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("DAS_TPU_VMEM_BUDGET", LAYOUTS[request.param])
    return request.param


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _route(plan, layout):
    want = budget.ROUTE_TILED if layout == "tiled" else budget.ROUTE_SINGLE
    assert plan.route == want, plan


def _table(rng, n, k, span, p_valid=0.8):
    vals = rng.integers(0, span, (n, k)).astype(np.int32)
    valid = rng.random(n) < p_valid
    vals[~valid] = 0
    return vals, valid


def _probe_inputs(rng, n, arity, key_dtype, key_span):
    keys = np.sort(rng.integers(0, key_span, n)).astype(key_dtype)
    keys[-8:] = np.iinfo(key_dtype).max  # capacity padding, as the store pads
    perm = rng.permutation(n).astype(np.int32)
    targets = rng.integers(0, 6, (n, arity)).astype(np.int32)
    return keys, perm, targets


#: (key dtype, key, fixed values, var_cols, eq_pairs, extra_fixed)
PROBE_CASES = [
    (np.int32, 1, [], (0, 1), (), ()),            # ROUTE_TYPE: int32 key_type
    (np.int64, 1, [3], (1, 2), (), (0,)),         # extra fixed position
    (np.int64, 2, [], (0, 1), ((0, 2),), ()),     # repeated variable
]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_plain_matches_tpu_kernel(case, layout):
    key_dtype, key, fvals, var_cols, eq_pairs, extra_fixed = case
    rng = np.random.default_rng(11)
    keys, perm, targets = _probe_inputs(rng, 2000, 3, key_dtype, 3)
    for cap in (3000, 64):   # window fits; total > cap (the retry signal)
        if cap == 3000:
            _route(budget.probe_plan(2000, 2000, 3, len(var_cols), cap), layout)
        want = probe_term_table_impl(
            keys, perm, targets, key_dtype(key), np.asarray(fvals, np.int32), cap,
            var_cols=var_cols, eq_pairs=eq_pairs, extra_fixed=extra_fixed,
            interpret=True,
        )
        got = kernels.probe_term_table(
            _t(keys), _t(perm), _t(targets), key, fvals, cap,
            var_cols=var_cols, eq_pairs=eq_pairs, extra_fixed=extra_fixed,
        )
        for w, g in zip(want, got):
            _same(w, g)
    assert int(got[2]) > 64


def _index_inputs(rng, m, type_key, span):
    targets = rng.integers(0, span, (m, 2)).astype(np.int32)
    keyarr = (np.int64(type_key) << 32) | targets[:, 0].astype(np.int64)
    perm = np.argsort(keyarr, kind="stable").astype(np.int32)
    return keyarr[perm], perm, targets


@pytest.mark.parametrize("pairs,extra", [(((0, 0),), (1,)), (((1, 0), (0, 1)), ())])
def test_index_join_plain_matches_tpu_kernel(pairs, extra, layout):
    rng = np.random.default_rng(12)
    keys, perm, targets = _index_inputs(rng, 2000, 5, 40)
    lv, lm = _table(rng, 300, 2, 40)
    for cap in (3000, 256):
        if cap == 3000:
            _route(budget.index_join_plan(300, 2, 2000, 2000, 2, 2 + len(extra), cap),
                   layout)
        want = index_join_impl(lv, lm, keys, perm, targets, np.int64(5), pairs,
                               (0, 1), extra, cap, interpret=True)
        got = kernels.index_join(_t(lv), _t(lm), _t(keys), _t(perm), _t(targets), 5,
                                 pairs, (0, 1), extra, cap)
        for w, g in zip(want, got):
            _same(w, g)


@pytest.mark.parametrize("pairs,extra", [(((0, 0),), (1,)), (((0, 1), (1, 0)), ())])
def test_join_tables_plain_matches_tpu_kernel(pairs, extra, layout):
    rng = np.random.default_rng(13)
    lv, lm = _table(rng, 300, 2, 30)
    rv, rm = _table(rng, 300, 2, 30)   # duplicate join keys: the tie order counts
    for cap in (3000, 512):
        if cap == 3000:
            _route(budget.join_plan(300, 2, 300, 2, len(pairs), 2 + len(extra), cap), layout)
        want = join_tables_impl(lv, lm, rv, rm, pairs, extra, cap, interpret=True)
        got = kernels.join_tables(_t(lv), _t(lm), _t(rv), _t(rm), pairs, extra, cap)
        for w, g in zip(want, got):
            _same(w, g)


@pytest.mark.parametrize("n_r,p_valid", [(300, 0.8), (300, 0.0)])
def test_anti_join_plain_matches_tpu_kernel(n_r, p_valid):
    # the TPU anti join is single-block only (one output per left row)
    rng = np.random.default_rng(14)
    lv, lm = _table(rng, 300, 2, 12)
    rv, rm = _table(rng, n_r, 2, 12, p_valid)
    for pairs in [((0, 0),), ((0, 1), (1, 0))]:
        want = anti_join_impl(lv, lm, rv, rm, pairs, interpret=True)
        got = kernels.anti_join(_t(lv), _t(lm), _t(rv), _t(rm), pairs)
        _same(want, got)


def test_plain_route_counts_no_launch():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(15)
    lv, lm = _table(rng, 10, 2, 4)
    kernels.join_tables(_t(lv), _t(lm), _t(lv), _t(lm), ((0, 0),), (1,), 64)
    kernels.anti_join(_t(lv), _t(lm), _t(lv), _t(lm), ((0, 0),))
    assert all(v == 0 for v in kernels.LAUNCH_COUNTS.values())
    from das_tpu_torch.kernels import launch

    assert all(v == 0 for v in launch.REGIME_COUNTS.values())



def _anti_join_set_mirror(lv, lm, rv, rm, pairs):
    """The algorithm of csrc/anti_join.cu in Python: a set of the valid
    right rows' mixed keys, plus the right sentinel once when any right
    row is invalid; a left row is kept iff it is valid and its mixed key is
    not in the set.  No sort."""
    key_l = mix_columns(_t(lv), tuple(a for a, _ in pairs), _t(lm), SENTINEL_L).tolist()
    key_r = mix_columns(_t(rv), tuple(b for _, b in pairs), _t(rm), SENTINEL_R).tolist()
    right = {k for k, m in zip(key_r, rm) if m}
    if not np.all(rm):
        right.add(SENTINEL_R)
    return np.array([bool(m) and k not in right for k, m in zip(key_l, lm)], dtype=bool)


@pytest.mark.parametrize("n_r,p_valid", [(300, 0.8), (300, 0.0), (0, 0.8), (40, 1.0),
                                         (9000, 0.8)],
                         ids=["mixed", "all_invalid_right", "empty_right", "all_valid_right",
                              "right_past_shared_set"])
@pytest.mark.parametrize("pairs", [((0, 0),), ((0, 1), (1, 0)), ((1, 1),)],
                         ids=["one_pair", "two_pairs", "second_column"])
def test_anti_join_set_mirror_matches_tpu_kernel(n_r, p_valid, pairs):
    rng = np.random.default_rng(19)
    lv, lm = _table(rng, 200, 2, 12)
    lv[:3] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rv, rm = _table(rng, n_r, 2, 12, p_valid)
    want = np.asarray(anti_join_impl(lv, lm, rv, rm, pairs, interpret=True))
    got = _anti_join_set_mirror(lv, lm, rv, rm, pairs)
    assert np.array_equal(want, got)
    if p_valid == 0.0:
        # only the right sentinel is in the set, which no left key equals
        assert np.array_equal(got, lm)
