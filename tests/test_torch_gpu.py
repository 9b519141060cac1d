"""The hand-written CUDA kernels of das_tpu_torch on the card.

Builds the kernels and holds each one — and the scan under the joins —
against its plain PyTorch version on the same CUDA tensors, exactly.  Without a card the test skips.  It imports no JAX, so it runs on
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


def _index_inputs(rng, m, type_key, span, capacity=None):
    """A (type<<32|target) posting index over target position 0 of m link
    rows, padded to `capacity` as the store pads (keys with int64 max, perm
    and targets with 0)."""
    capacity = m + 48 if capacity is None else capacity
    targets = np.zeros((capacity, 2), np.int32)
    targets[:m] = rng.integers(0, span, (m, 2))
    keyarr = (np.int64(type_key) << 32) | targets[:m, 0].astype(np.int64)
    perm = np.zeros(capacity, np.int32)
    perm[:m] = np.argsort(keyarr, kind="stable")
    keys = np.full(capacity, np.iinfo(np.int64).max, np.int64)
    keys[:m] = keyarr[perm[:m]]
    return keys, perm, targets


#: (key dtype, key, fixed values, var_cols, eq_pairs, extra_fixed)
PROBE_CASES = [
    (np.int32, 1, [], (0, 1), (), ()),
    (np.int64, 1, [3], (1, 2), (), (0,)),
    (np.int64, 2, [], (0, 1), ((0, 2),), ()),
]


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Every hand-written kernel, and the scan under the joins, against the
    plain PyTorch versions on the same CUDA tensors: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.kernels import launch

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)

    def c(x):
        return _t(x).to(dev)

    # the scan
    lib = launch.library()
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


def _star(rng, n_left, widths, span, rows):
    left = _table(rng, n_left, 2, span)
    tails, meta = [], []
    for w in widths:
        tails.append(_table(rng, rows, w, span))
        vcol = int(rng.integers(0, w))
        meta.append((vcol, tuple(c for c in range(w) if c != vcol)))
    return left, tails, tuple(meta)


@pytest.mark.gpu
def test_multiway_kernel_matches_plain_on_card():
    """Kernel 5 against its plain version on the same CUDA tensors, exactly:
    random stars of 1-3 tails with tied keys, totals past capacity, an
    all-invalid left side, an empty intersection, zero-row sides, a
    window product that wraps int64, and a star of 18 tails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)

    def c(x):
        return _t(x).to(dev)

    def check(left, tails, meta, vcol0, cap):
        args = ((c(left[0]), c(left[1])), [(c(v), c(m)) for v, m in tails])
        want = kernels.multiway_join_plain(*args[0], args[1], vcol0, meta, cap)
        got = kernels.multiway_join(*args[0], args[1], vcol0, meta, cap)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and torch.equal(w, g)
        return got

    for widths, span, rows in [((2,), 7, 5000), ((2, 3), 20, 3000), ((3, 1, 2), 20, 2000)]:
        left, tails, meta = _star(rng, 4000, widths, span, rows)
        for cap in (1 << 16, 100):
            check(left, tails, meta, 1, cap)
    left, tails, meta = _star(rng, 300, (2, 2), 5, 300)
    got = check((left[0] * 0, left[1] & False), tails, meta, 1, 512)
    assert int(got[2].abs().sum()) == 0
    got = check(left, [(v + 100, m) for v, m in tails], meta, 1, 512)
    assert int(got[2].abs().sum()) == 0
    check((left[0][:0], left[1][:0]), tails, meta, 1, 64)
    check(left, [tails[0], (tails[1][0][:0], tails[1][1][:0])], meta, 1, 64)
    n = 1 << 16
    tail = (np.zeros((n, 1), np.int32), np.ones(n, bool))
    got = check((np.zeros((1, 2), np.int32), np.ones(1, bool)), [tail] * 4,
                ((0, ()),) * 4, 0, 16)
    assert got[2].tolist() == [1 << 16, 1 << 32, 1 << 48, 0]
    left, tails, meta = _star(rng, 64, (2,) * 18, 3, 6)
    check(left, tails, meta, 1, 256)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_regimes_match_plain_on_card():
    """Every regime of kernels 3-5 against the plain versions on the same
    CUDA tensors, exactly, each call asserted to have taken its regime: the
    index join's block (1 launch) and global regimes over a padded posting
    index (totals and windows past capacity, all-invalid, empty and one-row
    left sides, negative join values, a failing second pair, no
    right_extra, an empty key column), the anti join's shared and global
    sets (all-invalid and empty right sides included), and the multiway
    block, filter and global regimes, with keys v and ~v (whose mixed keys
    collide), INT32_MIN / INT32_MAX, masked tail rows equal to a left value,
    the wraparound shape, 18 tails and 30 tails (more than the kernel
    parameters hold)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.kernels import launch

    dev = torch.device("cuda")
    rng = np.random.default_rng(18)

    def c(x):
        return _t(x).to(dev)

    keys, perm, targets = (c(x) for x in _index_inputs(rng, 60000, 5, 3000, 1 << 16))
    skew = tuple(c(x) for x in _index_inputs(rng, 2000, 5, 4))

    def index(left, pairs, extra, cap, regime, launches=None, index=(keys, perm, targets)):
        args = (c(left[0]), c(left[1]), *index, 5, pairs, (0, 1), extra, cap)
        want = kernels.index_join_plain(*args)
        got = kernels.index_join(*args)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g)
        assert launch.LAST_REGIME["index_join"] == regime
        if launches is not None:
            assert launch.DEVICE_LAUNCHES["index_join"] == launches
        return int(got[2]), int(got[1].sum())

    one, two = ((0, 0),), ((0, 0), (1, 1))
    small = _table(rng, 16, 2, 3000)
    negative = (small[0].copy(), np.ones(16, bool))
    negative[0][::3, 0] = -negative[0][::3, 0] - 1
    for cap in (2048, 4):
        total, valid = index(small, one, (1,), cap, "block", 1)
        assert valid == min(total, cap) and (total > cap) == (cap == 4)
    assert index((small[0], small[1] & False), one, (1,), 64, "block", 1) == (0, 0)
    assert index((small[0][:0], small[1][:0]), one, (1,), 64, "block", 1) == (0, 0)
    assert index((small[0][:1], np.ones(1, bool)), one, (), 64, "block", 1)[0] > 0
    index(negative, one, (1,), 2048, "block", 1)
    total, valid = index(small, two, (), 2048, "block", 1)
    assert valid < total
    assert index(_table(rng, 4, 2, 4), one, (1,), 256, "block", 1, skew)[0] > 256
    empty_index = (c(np.zeros(0, np.int64)), c(np.zeros(0, np.int32)), targets)
    assert index(small, one, (1,), 64, "block", 1, empty_index) == (0, 0)
    # the block regime's limits: 128 rows, cap 16,384, rows x cap <= 2^19
    limit = _table(rng, 129, 2, 3000)
    rows = lambda n: (limit[0][:n], limit[1][:n])   # noqa: E731
    index(rows(128), one, (1,), 4096, "block", 1)
    index(limit, one, (1,), 4096, "global", 3)
    index(rows(64), one, (1,), 8192, "block", 1)
    index(rows(64), one, (1,), 8200, "global", 3)
    index(small, one, (1,), 16384, "block", 1)
    big = _table(rng, 4096, 2, 3000)
    for cap in (1 << 16, 512):
        total, valid = index(big, one, (1,), cap, "global", 5)
        assert (total > cap) == (cap == 512)
    index((big[0], big[1] & False), two, (), 4096, "global", 5)
    index(small, one, (1,), 20000, "global", 3)              # cap past the block regime's
    assert index((small[0][:0], small[1][:0]), one, (1,), 20000, "global", 1) == (0, 0)

    def anti(left, right, pairs, regime):
        args = (c(left[0]), c(left[1]), c(right[0]), c(right[1]), pairs)
        assert torch.equal(kernels.anti_join_plain(*args), kernels.anti_join(*args))
        assert launch.LAST_REGIME["anti_join"] == regime

    lv, lm = _table(rng, 3000, 2, 50)
    for n_r, regime in [(500, "shared"), (8192, "shared"), (20000, "global")]:
        right = _table(rng, n_r, 2, 50)
        for pairs in [((0, 0),), ((0, 1), (1, 0))]:
            anti((lv, lm), right, pairs, regime)
        anti((lv, lm), (right[0], np.zeros(n_r, bool)), ((0, 0),), regime)
    anti((lv, lm), (np.zeros((0, 2), np.int32), np.zeros(0, bool)), ((0, 0),), "shared")

    def multiway(left, tails, meta, vcol0, cap, regime):
        args = ((c(left[0]), c(left[1])), [(c(v), c(m)) for v, m in tails])
        want = kernels.multiway_join_plain(*args[0], args[1], vcol0, meta, cap)
        got = kernels.multiway_join(*args[0], args[1], vcol0, meta, cap)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and torch.equal(w, g)
        assert launch.LAST_REGIME["multiway"] == regime
        return got

    def colliding(n, k, span, p_valid=0.8):
        vals, valid = _table(rng, n, k, span, p_valid)
        vals[:, 0] = np.where(rng.random(n) < 0.5, vals[:, 0], ~vals[:, 0])
        vals[::97, 0] = np.iinfo(np.int32).min
        vals[1::97, 0] = np.iinfo(np.int32).max
        return vals, valid

    meta2 = ((0, (1,)), (0, (1, 2)))
    for n_left, n_rows, cap, regime in [(128, 72, 64, "block"), (300, 20000, 4096, "filter"),
                                        (9000, 3000, 4096, "global")]:
        left = colliding(n_left, 2, 40)
        tails = [colliding(n_rows, 2, 40), colliding(n_rows // 8, 3, 40)]
        # masked tail rows that hold a left value
        tails[0][0][~tails[0][1], 0] = left[0][0, 0]
        for cap_ in (cap, 16):
            got = multiway(left, tails, meta2, 0, cap_, regime)
        assert int(got[2][-1]) > 16
    n = 1 << 16
    tail = (np.zeros((n, 1), np.int32), np.ones(n, bool))
    got = multiway((np.zeros((1, 2), np.int32), np.ones(1, bool)), [tail] * 4,
                   ((0, ()),) * 4, 0, 16, "filter")
    assert got[2].tolist() == [1 << 16, 1 << 32, 1 << 48, 0]
    left, tails, meta = _star(rng, 64, (2,) * 18, 3, 6)
    multiway(left, tails, meta, 1, 256, "block")
    left, tails, meta = _star(rng, 512, (2,) * 18, 3, 512)
    multiway(left, tails, meta, 1, 1024, "filter")
    left, tails, meta = _star(rng, 40, (2,) * 30, 3, 6)
    multiway(left, tails, meta, 1, 256, "filter")
    left, tails, meta = _star(rng, 9000, (2,) * 30, 40, 300)
    multiway(left, tails, meta, 1, 1024, "global")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_probe_and_join_match_plain_on_card():
    """Kernels 1 and 2 (csrc/probe.cu, csrc/join_tables.cu) against their
    plain versions on the same CUDA tensors, exactly, each call in its regime
    with its launch count: 19 probe terms in one call (two launches) with
    int32 and int64 keys, keys equal to the padding, an empty key column,
    rows of 0, 1, 2, 4 and 5 columns, extra_fixed and eq_pairs, ragged and
    past-count capacities; the sort-merge join's block and global regimes
    with ties, one and two pairs, all-invalid sides, empty sides, one left
    row and totals past capacity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.kernels import launch

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)

    def c(x):
        return _t(x).to(dev)

    cols = {dt: tuple(c(x) for x in _probe_inputs(rng, 2000, 6, dt, 3))
            for dt in (np.int32, np.int64)}
    #: (key dtype, var_cols, eq_pairs, extra_fixed)
    shapes = [(np.int32, (0, 1), (), ()), (np.int64, (1, 2, 3, 4), (), (0,)),
              (np.int64, (0, 1), ((0, 2),), ()), (np.int32, (), (), ()),
              (np.int64, (0,), (), ()), (np.int32, (0, 1, 2, 3, 5), ((1, 4),), (2,))]
    terms = []
    for n in range(18):
        dt, var_cols, eq_pairs, fixed = shapes[n % len(shapes)]
        key = n % 4 if n % 5 else int(np.iinfo(dt).max)
        terms.append(kernels.ProbeTerm(*cols[dt], key, [int(rng.integers(0, 6)) for _ in fixed],
                                       (64, 3001, 4096)[n % 3], var_cols, eq_pairs, fixed))
    terms.append(kernels.ProbeTerm(c(np.zeros(0, np.int64)), c(np.zeros(0, np.int32)),
                                   cols[np.int64][2], 1, [], 64, (0, 1), (), ()))
    want = kernels.probe_term_tables_plain(terms)
    got = kernels.probe_term_tables(terms)
    assert launch.LAST_REGIME["probe"] == "warp_search"
    assert launch.DEVICE_LAUNCHES["probe"] == 2
    for w3, g3 in zip(want, got):
        for w, g in zip(w3, g3):
            assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g)
    assert any(int(g[2]) > t.capacity for t, g in zip(terms, got))
    t = terms[1]
    one = kernels.probe_term_table(*t[:6], var_cols=t.var_cols, eq_pairs=t.eq_pairs,
                                   extra_fixed=t.extra_fixed)
    assert launch.DEVICE_LAUNCHES["probe"] == 1
    assert all(torch.equal(w, g) for w, g in zip(want[1], one))

    def join(left, right, pairs, extra, cap, regime):
        args = (c(left[0]), c(left[1]), c(right[0]), c(right[1]), pairs, extra, cap)
        want = kernels.join_tables_plain(*args)
        got = kernels.join_tables(*args)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g)
        assert launch.LAST_REGIME["join_tables"] == regime
        return int(got[2]), launch.DEVICE_LAUNCHES["join_tables"]

    left, right = _table(rng, 3000, 2, 50), _table(rng, 40, 3, 50)
    one_pair, two_pairs = ((0, 0),), ((0, 1), (1, 0))
    none = lambda tb: (tb[0], tb[1] & False)   # noqa: E731
    for cap in (4096, 3001, 64):
        total, n = join(left, right, one_pair, (1, 2), cap, "block")
        assert n == 1 and (total > cap) == (cap == 64)
        join(left, right, two_pairs, (2,), cap, "block")
    join(none(left), right, one_pair, (1,), 4096, "block")
    join(left, none(right), two_pairs, (), 4096, "block")
    join((left[0][:1], np.ones(1, bool)), right, one_pair, (1,), 64, "block")
    assert join(left, (right[0][:0], right[1][:0]), one_pair, (1,), 64, "block") == (0, 1)
    assert join((left[0][:0], left[1][:0]), right, one_pair, (1,), 64, "block") == (0, 1)
    big_right = _table(rng, 65536, 2, 3000)      # past the block regime's shared memory
    for cap in (1 << 16, 512):
        total, n = join(left, big_right, one_pair, (1,), cap, "global")
        assert n <= 11 and (total > cap) == (cap == 512)
    join(none(left), big_right, one_pair, (1,), 4096, "global")
    join(left, none(big_right), two_pairs, (), 4096, "global")
    big_left = _table(rng, 30000, 2, 50)
    join(big_left, right, one_pair, (1, 2), 1 << 16, "global")
    assert join(big_left, (right[0][:0], right[1][:0]), one_pair, (1,), 64, "global") == (0, 1)
    join(left, right, one_pair, (1,), 20000, "global")     # cap past the block regime's
    torch.cuda.synchronize()


#: bench.py SMALL
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5, n_interactions=300,
             n_evaluations=0)


def _bio_queries(names):
    """Grounded and Not queries, a duplicate, the triangle and two reseed
    shapes (two grounded Member terms, then a whole-type Interacts term)."""
    from das_tpu_torch.query.ast import And, Link, Node, Not, Variable

    def grounded(g, negate=False):
        third = Link("Interacts", [Node("Gene", g), Variable("V2")], True)
        return And([Link("Member", [Node("Gene", g), Variable("V3")], True),
                    Link("Member", [Variable("V2"), Variable("V3")], True),
                    Not(third) if negate else third])

    def reseed(g1, g2):
        return And([Link("Member", [Node("Gene", g1), Variable("V3")], True),
                    Link("Member", [Node("Gene", g2), Variable("V3")], True),
                    Link("Interacts", [Variable("V1"), Variable("V2")], True)])

    triangle = And([Link("Member", [Variable("V1"), Variable("V3")], True),
                    Link("Member", [Variable("V2"), Variable("V3")], True),
                    Link("Interacts", [Variable("V1"), Variable("V2")], True)])
    batch = ([grounded(g) for g in names[:8]] + [grounded(g, True) for g in names[:8]]
             + [grounded(names[0]), triangle])
    return batch, [reseed(names[10 + i], names[20 + i]) for i in range(4)]


@pytest.mark.gpu
def test_query_many_on_card_equals_query(monkeypatch):
    """query_many on the card: the strings query() gives, and one host
    fetch per retry round of the batch (not one per query)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.query import fused

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    das = DistributedAtomSpace(backend="tensor", data=data, device="cuda")
    batch, _reseeds = _bio_queries(names)
    rounds = {}
    dispatch = fused._ExecJob.dispatch

    def recording(job):
        out = dispatch(job)
        rounds[job] = job.rounds
        return out

    monkeypatch.setattr(fused._ExecJob, "dispatch", recording)
    f0 = fused.FETCH_COUNTS["n"]
    got = das.query_many(batch)
    assert fused.FETCH_COUNTS["n"] - f0 == max(rounds.values()) < len(batch)
    assert got == [das.query(q) for q in batch]
    assert got[0] == got[16] and any(got[:8])


@pytest.mark.gpu
def test_execute_exact_on_card_equals_cpu():
    """The exact reference-order program on the card against the same
    program on the CPU (the plain versions): names, count, stats, rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.query import compiler, fused
    from das_tpu_torch.storage.tensor_db import TensorDB

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    card, cpu = TensorDB(data, device="cuda"), TensorDB(data, device="cpu")
    _batch, reseeds = _bio_queries(names)
    re_seeded = 0
    for q in reseeds:
        want = fused.get_executor(cpu).execute_exact(compiler.plan_query(cpu, q))
        got = fused.get_executor(card).execute_exact(compiler.plan_query(card, q))
        assert (got.var_names, got.count) == (want.var_names, want.count)
        assert got.stats.tolist() == want.stats.tolist()
        rows = [{tuple(r) for r in res.host_vals[res.host_valid].tolist()} for res in (got, want)]
        assert rows[0] == rows[1] and len(rows[0]) == got.count
        re_seeded += int(got.stats[1]) > 0
    assert re_seeded >= 1


def _commit_lines(names, procs, k):
    """Commit k: 8 new genes, each a Member of two existing processes and
    Interacts with an existing gene; the generator's nodes are declared again
    so that the parser resolves them (a declaration adds no atom)."""
    lines = [f'(: "{p}" BiologicalProcess)' for p in procs[:4]]
    lines += [f'(: "{g}" Gene)' for g in names[:4]]
    for i in range(8):
        g = f"GENE:commit{k}_{i}"
        lines += [f'(: "{g}" Gene)', f'(Member "{g}" "{procs[i % 4]}")',
                  f'(Member "{g}" "{procs[(i + 1) % 4]}")', f'(Interacts "{g}" "{names[i % 4]}")']
    return lines


@pytest.mark.gpu
def test_commit_on_card_equals_cpu():
    """Incremental commits on the card leave the device tables the CPU port
    leaves, bit for bit, and the same answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device merge runs on the card here")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.storage.tensor_db import BUCKET_LIST_PADS, BUCKET_PADS

    stores = []
    for device in ("cuda", "cpu"):
        data, genes, procs = build_bio_atomspace(seed=5, **SMALL)
        names = [data.nodes[h].name for h in genes]
        pnames = [data.nodes[h].name for h in procs]
        das = DistributedAtomSpace(backend="tensor", data=data, device=device)
        for k in range(3):
            tx = das.open_transaction()
            for line in _commit_lines(names, pnames, k):
                tx.add(line)
            das.commit_transaction(tx)
        stores.append(das)
    card, cpu = stores
    assert card.db._delta_total == cpu.db._delta_total == 3 * 32
    assert card.db.delta_version == cpu.db.delta_version == 4
    for arity, cb in cpu.db.dev.buckets.items():
        gb = card.db.dev.buckets[arity]
        assert (gb.size, gb.capacity) == (cb.size, cb.capacity)
        for name, _ in BUCKET_PADS:
            assert torch.equal(getattr(gb, name).cpu(), getattr(cb, name)), name
        for name, _ in BUCKET_LIST_PADS:
            for g, c in zip(getattr(gb, name), getattr(cb, name)):
                assert torch.equal(g.cpu(), c), name
    batch, _reseeds = _bio_queries([f"GENE:commit2_{i}" for i in range(8)] * 3)
    assert card.query_many(batch[:17]) == cpu.query_many(batch[:17])


@pytest.mark.gpu
def test_explain_execute_on_card_equals_cpu():
    """explain(execute=True) on the card reports the CPU port's plan and
    actual rows; a planned chain's predicted route names the hand-written
    kernels where the CPU names their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import build_bio_atomspace

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    card = DistributedAtomSpace(backend="tensor", data=data, device="cuda")
    cpu = DistributedAtomSpace(backend="tensor", data=data, device="cpu")
    batch, reseeds = _bio_queries(names)
    for q in batch[:4] + batch[8:10] + batch[-1:] + reseeds[:2]:
        want, got = cpu.explain(q, execute=True), card.explain(q, execute=True)
        route = want.pop("route")
        if want["planned"] and route == "fused":
            route = "fused_kernel"   # a planned chain on the card names its kernels
        assert got.pop("route") == route
        assert got == want
        assert got["actual"] is not None


def _tree_queries(names):
    """The tree executor's shapes on the bio KB: Ors of grounded chains over
    one variable universe (the whole-tree job: a union, 3 branches, a Not
    branch), an Or over different variable sets and an And over an Or (the
    staged tree), and an unordered Interacts template joined to a grounded
    Member term (a U table and a composite join)."""
    from das_tpu_torch.query.ast import And, Link, LinkTemplate, Node, Not, Or, TypedVariable
    from das_tpu_torch.query.ast import Variable as V

    def chain(g):
        return And([Link("Member", [Node("Gene", g), V("V3")], True),
                    Link("Member", [V("V2"), V("V3")], True)])

    return [
        Or([chain(names[0]), chain(names[1])]),
        Or([chain(g) for g in names[:3]]),
        Or([chain(names[0]), Not(chain(names[1]))]),
        Or([chain(names[0]), Link("Interacts", [Node("Gene", names[1]), V("V5")], True)]),
        And([Or([chain(names[0]), chain(names[1])]),
             Link("Interacts", [Node("Gene", names[0]), V("V2")], True)]),
        And([Link("Member", [Node("Gene", names[0]), V("V3")], True),
             LinkTemplate("Interacts", [TypedVariable("V1", "Gene"),
                                        TypedVariable("V2", "Gene")], False),
             Link("Member", [V("V1"), V("V3")], True)]),
    ]


@pytest.mark.gpu
def test_tree_on_card_equals_cpu():
    """The tree executor on the card (its joins and negation filters on the
    hand-written kernels) against the same store on the CPU: answers,
    routes, and each whole-tree job's stats vector and table bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.query import compiler, fused, plan, tree

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    card = DistributedAtomSpace(backend="tensor", data=data, device="cuda")
    cpu = DistributedAtomSpace(backend="tensor", data=data, device="cpu")
    launched = dict(kernels.LAUNCH_COUNTS)
    fused_jobs = 0
    for q in _tree_queries(names):
        routes = []
        answers = []
        for das in (card, cpu):
            r0 = dict(compiler.ROUTE_COUNTS)
            matched, answer = das.query_answer(q)
            routes.append({k: compiler.ROUTE_COUNTS[k] - r0[k]
                           for k in ("tree", "fused_tree", "host")})
            answers.append((matched, answer.negation, answer.assignments))
        assert routes[0] == routes[1] and routes[0]["host"] == 0 and routes[0]["tree"] == 1
        assert answers[0] == answers[1]
        sites = tree.tree_fusion_sites(plan.build_plan(card.db, q))
        if sites is None:
            continue
        jobs = [fused.get_executor(d.db).execute_tree(sites[0], sites[1]) for d in (card, cpu)]
        for j in jobs:
            assert j.result is not None
        (cv, cm, cs), (pv, pm, ps) = (fused.fetch(*j.dispatch()) for j in jobs)
        assert cs.tolist() == ps.tolist() and cm.tolist() == pm.tolist()
        assert cv[cm].tolist() == pv[pm].tolist()
        fused_jobs += 1
    assert fused_jobs == 3
    for name in ("probe", "join_tables", "anti_join"):
        assert kernels.LAUNCH_COUNTS[name] > launched[name], name


@pytest.mark.gpu
def test_device_probes_on_card_equal_cpu():
    """The store's probe_*_padded on the card equal the CPU route's, and so
    do get_links' answers (animals: the unordered Similarity probes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.hashing import ExpressionHasher, hex_to_i64
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.storage.atom_table import load_metta_text

    stores = [DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                                   device=d) for d in ("cuda", "cpu")]

    def probes(das):
        db = das.db
        row = {n: db.fin.row_of_hex[db.get_node_handle("Concept", n)]
               for n in ("human", "mammal", "snake")}
        inh, sim = db._type_id("Inheritance"), db._type_id("Similarity")
        table = db.data.table
        ctype = int(hex_to_i64(ExpressionHasher.composite_hash(
            [table.get_named_type_hash(t) for t in ("Inheritance", "Concept", "Concept")])))
        out = [db.probe_ordered_padded(2, inh, ((0, row["human"]),)),
               db.probe_ordered_padded(2, None, ((1, row["mammal"]),)),
               db.probe_ordered_padded(2, inh, ()),
               db.probe_ordered_padded(2, None, ()),
               db.probe_unordered_padded(2, sim, ((row["human"], 1),)),
               db.probe_unordered_padded(2, None, ((row["snake"], 1),)),
               db.probe_ctype_padded(2, ctype)]
        h = db.get_node_handle("Concept", "human")
        links = [das.get_links("Similarity", targets=[h, "*"]),
                 das.get_links("*", targets=["*", db.get_node_handle("Concept", "mammal")]),
                 das.get_links("Inheritance", target_types=["Concept", "Concept"])]
        return [(loc.cpu().tolist(), m.cpu().tolist()) for loc, m in out], links

    assert probes(stores[0]) == probes(stores[1])


@pytest.mark.gpu
def test_snapshot_commits_restore_on_card_equals_cpu(tmp_path):
    """A SMALL store snapshotted at construction, committed to twice and
    restored with device="cuda" holds the tables the CPU-restored store
    holds, bit for bit, and answers a grounded and a Not query the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the restored tables live on the card")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.storage.tensor_db import BUCKET_LIST_PADS, BUCKET_PADS

    data, genes, procs = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    pnames = [data.nodes[h].name for h in procs]
    root = str(tmp_path / "root")
    live = DistributedAtomSpace(backend="tensor", data=data, device="cuda",
                                config=DasConfig(snapshot_dir=root))
    for k in range(2):
        tx = live.open_transaction()
        for line in _commit_lines(names, pnames, k):
            tx.add(line)
        live.commit_transaction(tx)
    card, cpu = (DistributedAtomSpace(backend="tensor", device=d,
                                      config=DasConfig(snapshot_dir=root))
                 for d in ("cuda", "cpu"))
    assert card.db.delta_version == cpu.db.delta_version == live.db.delta_version == 3
    for arity, cb in cpu.db.dev.buckets.items():
        gb = card.db.dev.buckets[arity]
        assert gb.rows.device.type == "cuda" and (gb.size, gb.capacity) == (cb.size, cb.capacity)
        for name, _ in BUCKET_PADS:
            assert torch.equal(getattr(gb, name).cpu(), getattr(cb, name)), name
        for name, _ in BUCKET_LIST_PADS:
            for g, c in zip(getattr(gb, name), getattr(cb, name)):
                assert torch.equal(g.cpu(), c), name
    batch, _reseeds = _bio_queries(["GENE:commit1_0"] + names[:30])
    queries = batch[0:2] + batch[8:10]      # grounded and Not, a new and an old gene
    assert [card.query(q) for q in queries] == [cpu.query(q) for q in queries]
    assert [card.query(q) for q in queries] == [live.query(q) for q in queries]


@pytest.mark.gpu
def test_columnar_load_on_card_equals_cpu(tmp_path):
    """A canonical SMALL file loaded through the native scanner's columnar
    route with device="cuda" holds the tables the CPU load holds, bit for
    bit, and answers a grounded and a Not query the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the loaded tables live on the card")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import write_bio_canonical
    from das_tpu_torch.storage.tensor_db import BUCKET_LIST_PADS, BUCKET_PADS

    path = str(tmp_path / "small.metta")
    write_bio_canonical(path, seed=5, **SMALL)
    card, cpu = (DistributedAtomSpace(backend="tensor", device=d) for d in ("cuda", "cpu"))
    for das in (card, cpu):
        das.load_canonical_knowledge_base(path)
        assert das.data.columnar is not None
    for name in ("node_type_id", "incoming_offsets", "incoming_links"):
        assert torch.equal(getattr(card.db.dev, name).cpu(), getattr(cpu.db.dev, name)), name
    for arity, cb in cpu.db.dev.buckets.items():
        gb = card.db.dev.buckets[arity]
        assert gb.rows.device.type == "cuda" and (gb.size, gb.capacity) == (cb.size, cb.capacity)
        for name, _ in BUCKET_PADS:
            assert torch.equal(getattr(gb, name).cpu(), getattr(cb, name)), name
        for name, _ in BUCKET_LIST_PADS:
            for g, c in zip(getattr(gb, name), getattr(cb, name)):
                assert torch.equal(g.cpu(), c), name
    names = sorted(r.name for r in cpu.data.nodes.values() if r.named_type == "Gene")[:30]
    batch, _reseeds = _bio_queries(names)
    queries = batch[0:2] + batch[8:10]
    assert [card.query(q) for q in queries] == [cpu.query(q) for q in queries]


@pytest.mark.gpu
def test_miner_star_counts_three_ways_on_card():
    """The miner on a SMALL store on the card, then its drawn composites
    with a grounded term and the sub-joints it counted for their scores,
    each counted three ways: the host star fold, the device fold on the
    card, and count_batch (the probe and join kernels), what it declines
    through count_matches_staged.  All equal, and equal to the host fold of
    the same store on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device fold and count_batch run on the GPU")
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.mining import PatternMiner
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.query import compiler, starcount
    from das_tpu_torch.query.ast import Node
    from das_tpu_torch.query.fused import get_executor
    from das_tpu_torch.storage.tensor_db import TensorDB

    data, _, _ = build_bio_atomspace(seed=5, **SMALL)
    card = TensorDB(data, DasConfig(), device="cuda")
    cpu = TensorDB(data, DasConfig(), device="cpu")
    miner = PatternMiner(card, halo_length=2, link_rate=0.3, seed=7)
    batches = []
    count_many = miner.count_many
    miner.count_many = lambda qs: batches.append(list(qs)) or count_many(qs)
    miner.expand_halo([card.get_node_handle("Gene", g)
                       for g in card.get_all_nodes("Gene", names=True)[:3]])
    miner.build_patterns()
    assert miner.mine(ngram=3, epochs=60) is not None and len(batches) == 3

    def grounded(q):
        return any(isinstance(t, Node) for term in q.terms for t in term.targets)

    queries = list({repr(q): q for q in batches[1] + batches[2] if grounded(q)}.values())
    assert len(queries) >= 32
    counts = {}
    for db, fold in ((cpu, starcount.star_count_many), (card, starcount.star_count_many),
                     (card, starcount._device_count_group)):
        lanes = [starcount.plan_star(db, compiler.plan_query(db, q)) for q in queries]
        counts[db.device.type, fold.__name__] = fold(db, lanes)
    plans = [compiler.plan_query(card, q) for q in queries]
    kernels.reset_launch_counts()
    batch = get_executor(card).count_batch(plans)
    counts["cuda", "fused"] = [compiler.count_matches_staged(card, p) if n is None else n
                               for p, n in zip(plans, batch)]
    assert len(set(map(tuple, counts.values()))) == 1, counts
    assert sum(n > 0 for n in counts["cpu", "star_count_many"]) >= 8
    assert kernels.LAUNCH_COUNTS["probe"] > 0
    assert kernels.LAUNCH_COUNTS["index_join"] + kernels.LAUNCH_COUNTS["join_tables"] \
        + kernels.LAUNCH_COUNTS["multiway"] > 0


@pytest.mark.gpu
def test_coalescer_on_card_equals_query():
    """Concurrent requests through DasService's coalescer on the card: the
    strings serial query() gives, fewer batches than requests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    import threading

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.service.query_dsl import parse_query
    from das_tpu_torch.service.server import DasService

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    das = DistributedAtomSpace(backend="tensor", data=data, device="cuda")
    dsl = [f"Node g Gene {g}, Link Member g $V3, Link Member $V2 $V3, "
           f"Link Interacts g $V2{', NOT' if i % 3 == 0 else ''}, AND"
           for i, g in enumerate(names[:48])]
    want = [das.query(parse_query(q)) for q in dsl]
    assert sum(bool(w) for w in want) >= 8
    svc = DasService(backend="tensor")
    key = svc.attach_tenant("bio", das)
    got = [None] * len(dsl)

    def client(k):
        for i in range(k, len(dsl), 6):
            got[i] = svc.query({"key": key, "query": dsl[i]})

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [g["msg"] for g in got] == want and all(g["success"] for g in got)
    stats = svc.coalescer_stats()
    assert stats["items"] == len(dsl) and stats["batches"] < len(dsl)


@pytest.mark.gpu
def test_pipelined_settle_does_not_wait_for_next_group():
    """Group k's settle waits on its own CUDA event: with a sleep kernel
    queued before group k+1's kernels, it returns long before the sleep
    ends, with the answers query() gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    import time

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.bio import build_bio_atomspace

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    das = DistributedAtomSpace(backend="tensor", data=data, device="cuda",
                               config=DasConfig(result_cache_size=0))
    batch, _ = _bio_queries(names)
    group_k = [q for q, a in zip(batch[:8], [das.query(q) for q in batch[:8]]) if a]
    group_k1 = batch[8:16]
    assert len(group_k) >= 2
    want = [das.query(q) for q in group_k]
    das.query_many(group_k)          # capacities learned: one round each
    das.query_many(group_k1)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    job_k = das.query_many_dispatch(group_k)
    torch.cuda._sleep(2_000_000_000)  # about a second of card time
    job_k1 = das.query_many_dispatch(group_k1)
    got = job_k.settle()
    settle_ms = (time.perf_counter() - t0) * 1e3
    rest = job_k1.settle()
    card_ms = (time.perf_counter() - t0) * 1e3
    assert got == want
    assert rest == [das.query(q) for q in group_k1]
    assert settle_ms * 4 < card_ms, (settle_ms, card_ms)


@pytest.mark.gpu
def test_sharded_store_on_card_equals_tensor():
    """The sharded store on SMALL with 8 slabs on cuda:0 against the tensor
    store on the card: every answer equal, the whole-tree mesh job too, and
    all five kernels launched on the slabs (an index join, a broadcast-right
    and a hash-partitioned join, an anti join, a multiway step); the fused
    sharded job's stats and per-shard tables bit for bit against the same
    store on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.parallel import fused_sharded as fs
    from das_tpu_torch.query import compiler, fused
    from das_tpu_torch.query.ast import And, Link, LinkTemplate, Node, TypedVariable, Variable

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    cfg = lambda: DasConfig(mesh_shape=(8,), use_multiway="on")  # noqa: E731
    card = DistributedAtomSpace(backend="sharded", data=data, device="cuda:0", config=cfg())
    cpu = DistributedAtomSpace(backend="sharded", data=data, device="cpu", config=cfg())
    ref = DistributedAtomSpace(backend="tensor", data=data, device="cuda",
                               config=DasConfig(use_multiway="on"))
    assert card.db.mesh.devices == (torch.device("cuda", 0),) * 8
    template = [And([Link("Interacts", [Node("Gene", g), Variable("V1")], True),
                     LinkTemplate("Interacts", [TypedVariable("V1", "Gene"),
                                                TypedVariable("V2", "Gene")], True)])
                for g in names[:4]]
    batch, reseeds = _bio_queries(names)
    queries = [*batch, *reseeds, *_tree_queries(names), *template]
    before = dict(kernels.LAUNCH_COUNTS)
    fs.get_sharded_executor(card.db).broadcast_limit = 0   # the template joins partition
    for q in queries:
        got, want = card.query_answer(q), ref.query_answer(q)
        assert (bool(got[0]), got[1].negation, got[1].assignments) == \
            (bool(want[0]), want[1].negation, want[1].assignments)
    for name in ("probe", "index_join", "join_tables", "anti_join", "multiway"):
        assert kernels.LAUNCH_COUNTS[name] > before[name], name
    fs.get_sharded_executor(card.db).broadcast_limit = fs.BROADCAST_LIMIT
    for q in [*batch[:4], template[0]]:
        outs = []
        for das in (card, cpu):
            ex = fs.get_sharded_executor(das.db)
            ex._caps.clear()   # the same capacities on both sides
            job = ex._exec_job(compiler.plan_query(das.db, q), False)
            while True:
                out = job.dispatch()
                host = fused.fetch(*out)
                if job.settle(host, out):
                    break
            outs.append((host[0].tolist(), job.result.host_vals, job.result.host_valid))
        assert outs[0][0] == outs[1][0]
        assert np.array_equal(outs[0][1], outs[1][1]) and np.array_equal(outs[0][2], outs[1][2])


_MULTIHOST_WORKER = """
import json, sys

from das_tpu_torch.query.ast import And, Link, LinkTemplate, Not, Node, TypedVariable, Variable


def queries():
    inh = lambda a, b: Link("Inheritance", [a, b], True)  # noqa: E731
    V = Variable
    return [
        And([inh(V("V1"), V("V3")), inh(V("V2"), V("V3")),
             Not(inh(V("V1"), Node("Concept", "mammal")))]),
        And([inh(V("V1"), V("V3")), inh(V("V2"), V("V3")), inh(V("V4"), V("V3"))]),
        And([inh(V("V1"), V("V2")), LinkTemplate(
            "Inheritance", [TypedVariable("V2", "Concept"), TypedVariable("V3", "Concept")],
            True)]),
    ]


def stats(mesh):
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.parallel.fused_sharded import get_sharded_executor
    from das_tpu_torch.parallel.sharded_db import ShardedDB
    from das_tpu_torch.query import compiler, fused
    from das_tpu_torch.storage.atom_table import load_metta_text

    db = ShardedDB(load_metta_text(animals_metta()), DasConfig(), mesh=mesh)
    ex = get_sharded_executor(db)
    ex.broadcast_limit = 0   # the template join hash-partitions
    out = []
    for q in queries():
        job = ex._exec_job(compiler.plan_query(db, q), True)
        while True:
            dev = job.dispatch()
            host = fused.fetch(*dev)
            if job.settle(host, dev):
                break
        out.append([int(x) for x in host[0]])
    return out


if __name__ == "__main__":
    from das_tpu_torch.parallel import mesh as M

    M.multihost_initialize(sys.argv[1], num_processes=2, process_id=int(sys.argv[2]),
                           timeout_s=120)
    print("RESULT " + json.dumps(stats(M.make_mesh(4, device="cuda:0"))), flush=True)
"""


@pytest.mark.gpu
def test_two_process_mesh_on_card_equals_one_process(tmp_path):
    """Two processes of 2 slabs each on cuda:0 (gloo, staged through the
    host) give the stats vectors of one process's 4-slab mesh on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    import importlib.util
    import json
    import os
    import socket
    import subprocess
    import sys

    from das_tpu_torch.parallel import mesh as M

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_MULTIHOST_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, str(script), f"127.0.0.1:{port}", str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        got.append(json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:]))
    spec = importlib.util.spec_from_file_location("multihost_worker", script)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    want = worker.stats(M.make_mesh(4, device="cuda:0"))
    assert got[0] == got[1] == want
    assert all(w[0] > 0 for w in want)


@pytest.mark.gpu
def test_ledger_measures_peak_bytes_on_card():
    """With the ledger on, a first call on the card records the allocator's
    peak rise and a finite budget-vs-actual ratio."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels only run on the GPU")
    import math

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.models.bio import build_bio_atomspace
    from das_tpu_torch.obs import proflog
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    data, genes, _ = build_bio_atomspace(seed=5, **SMALL)
    names = [data.nodes[h].name for h in genes]
    das = DistributedAtomSpace(backend="tensor", data=data, device="cuda")
    proflog.configure(enabled=True)
    proflog.reset()
    try:
        q = And([Link("Member", [Node("Gene", names[0]), Variable("V3")], True),
                 Link("Member", [Variable("V2"), Variable("V3")], True)])
        ok, _ans = das.query_answer(q)
        assert ok
        rows = [r for r in proflog.rows(site="fused") if r["compiles"]]
        assert rows and rows[0]["peak_bytes"] > 0 and rows[0]["compile_s"] > 0
        ratio = rows[0]["budget_vs_actual_ratio"]
        assert ratio is not None and math.isfinite(ratio) and ratio > 0
        assert all(r["kind"] == "cuda" for r in proflog.rows(site="kernel"))
        assert proflog.snapshot()["budget_vs_actual"]["fused"] == pytest.approx(ratio)
    finally:
        proflog.reset()
        proflog.configure(enabled=False)


@pytest.mark.gpu
def test_dump_trace_is_one_file_on_one_clock(tmp_path):
    """scripts/dump_trace_torch.py on the card writes one Chrome trace: the
    profiler's CUDA stream with the recorder's spans merged onto its clock.
    Every kernel launched inside a `serve.dispatch` span starts after that
    span's start, and every launch of the worker's host thread lies inside
    one of its dispatch or settle spans (chip_smoke.py `check_one_clock`,
    which phase entry runs on the same file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the clock marker is a kernel")
    import importlib.util
    import json
    from pathlib import Path

    import chip_smoke
    from das_tpu_torch import obs

    path = Path(__file__).resolve().parents[1] / "scripts" / "dump_trace_torch.py"
    spec = importlib.util.spec_from_file_location("_dump_trace_torch_gpu", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "trace.json"
    try:
        assert script.main(["-o", str(out), "--clients", "8", "--scale", "0.05"]) == 0
    finally:
        obs.configure(enabled=False)
        obs.proflog.configure(enabled=False)
        obs.reset()
        obs.proflog.reset()
    events = json.loads(out.read_text())["traceEvents"]
    clock = chip_smoke.check_one_clock(events)
    assert clock["dispatch_launches"] > 0 and clock["nearest_lead_us"] >= 0
