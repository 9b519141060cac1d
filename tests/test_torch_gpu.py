"""The hand-written CUDA kernels of das_tpu_torch on the card.

Builds the kernels and holds each one — and the scan and radix sort under
the joins — against its plain PyTorch version on the same CUDA tensors,
exactly.  Without a card the test skips.  It imports no JAX, so it runs on
the GPU machine alone:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from das_tpu_torch import kernels


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _table(rng, n, k, span, p_valid=0.8):
    vals = rng.integers(0, span, (n, k)).astype(np.int32)
    valid = rng.random(n) < p_valid
    vals[~valid] = 0
    return vals, valid


def _probe_inputs(rng, n, arity, key_dtype, key_span):
    keys = np.sort(rng.integers(0, key_span, n)).astype(key_dtype)
    keys[-8:] = np.iinfo(key_dtype).max
    perm = rng.permutation(n).astype(np.int32)
    targets = rng.integers(0, 6, (n, arity)).astype(np.int32)
    return keys, perm, targets


def _index_inputs(rng, m, type_key, span):
    targets = rng.integers(0, span, (m, 2)).astype(np.int32)
    keyarr = (np.int64(type_key) << 32) | targets[:, 0].astype(np.int64)
    perm = np.argsort(keyarr, kind="stable").astype(np.int32)
    return keyarr[perm], perm, targets


#: (key dtype, key, fixed values, var_cols, eq_pairs, extra_fixed)
PROBE_CASES = [
    (np.int32, 1, [], (0, 1), (), ()),
    (np.int64, 1, [3], (1, 2), (), (0,)),
    (np.int64, 2, [], (0, 1), ((0, 2),), ()),
]


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Every hand-written kernel, and the scan and radix sort under them,
    against the plain PyTorch versions on the same CUDA tensors: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.kernels import launch

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)

    def c(x):
        return _t(x).to(dev)

    # the primitives: stable argsort with ties and both signs, and the scan
    lib = launch.library()
    n = 70_000
    keys = c(rng.integers(-50, 50, n).astype(np.int64) * (2**40))
    s = launch.sort_scratch(n, 0, dev)
    err = lib.das_argsort_i64(
        keys.data_ptr(), n, s["key_r_sorted"].data_ptr(), s["order"].data_ptr(),
        s["tmp_keys"].data_ptr(), s["tmp_idx"].data_ptr(), s["hist"].data_ptr(),
        s["hist_incl"].data_ptr(), s["scan"].data_ptr(), s["scan_len"],
        launch.stream_of(dev))
    launch.raise_on(err, "argsort")
    order = torch.argsort(keys, stable=True)
    assert torch.equal(s["order"][:n].long(), order)
    assert torch.equal(s["key_r_sorted"][:n], keys[order])
    cnt = c(rng.integers(0, 5, 5_000_000).astype(np.int64))
    out = torch.empty_like(cnt)
    scratch_len = launch.scan_scratch(cnt.numel())
    scratch = torch.empty(scratch_len, dtype=torch.int64, device=dev)
    err = lib.das_scan_inclusive_i64(cnt.data_ptr(), out.data_ptr(), cnt.numel(),
                                     scratch.data_ptr(), scratch_len, launch.stream_of(dev))
    launch.raise_on(err, "scan")
    assert torch.equal(out, torch.cumsum(cnt, 0))

    for case in PROBE_CASES:
        key_dtype, key, fvals, var_cols, eq_pairs, extra_fixed = case
        k, p, tg = (c(x) for x in _probe_inputs(rng, 2000, 3, key_dtype, 3))
        for cap in (3000, 64):
            args = (k, p, tg, key, fvals, cap)
            kw = dict(var_cols=var_cols, eq_pairs=eq_pairs, extra_fixed=extra_fixed)
            for w, g in zip(kernels.probe_term_table_plain(*args, **kw),
                            kernels.probe_term_table(*args, **kw)):
                assert torch.equal(w, g)
    keys, perm, targets = (c(x) for x in _index_inputs(rng, 2000, 5, 40))
    lv, lm = (c(x) for x in _table(rng, 300, 2, 40))
    rv, rm = (c(x) for x in _table(rng, 300, 2, 40))
    empty_v, empty_m = c(np.zeros((0, 2), np.int32)), c(np.zeros(0, bool))
    for cap in (3000, 256):
        for pairs, extra in [(((0, 0),), (1,)), (((1, 0), (0, 1)), ())]:
            args = (lv, lm, keys, perm, targets, 5, pairs, (0, 1), extra, cap)
            for w, g in zip(kernels.index_join_plain(*args), kernels.index_join(*args)):
                assert torch.equal(w, g)
        for left, right in [((lv, lm), (rv, rm)), ((empty_v, empty_m), (rv, rm)),
                            ((lv, lm), (empty_v, empty_m))]:
            args = (*left, *right, ((0, 0),), (1,), cap)
            for w, g in zip(kernels.join_tables_plain(*args), kernels.join_tables(*args)):
                assert torch.equal(w, g)
    for right in [(rv, rm), (empty_v, empty_m)]:
        args = (lv, lm, *right, ((0, 1), (1, 0)))
        assert torch.equal(kernels.anti_join_plain(*args), kernels.anti_join(*args))
    torch.cuda.synchronize()
