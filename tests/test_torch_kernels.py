"""The port's kernel wrappers (das_tpu_torch/kernels/) against the JAX
package's TPU kernels.

On the CPU each wrapper takes its plain PyTorch version; here that is held
bit for bit against `das_tpu.kernels.*_impl(..., interpret=True)` — the
direct-discharge route the JAX package's own kernel tests use — in both
the single-block and the grid-chunked layout (forced through the JAX
bytes planner's DAS_TPU_VMEM_BUDGET).  The same wrappers on the card are
held against these plain versions by tests/test_torch_gpu.py."""

import functools

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


def _index_inputs(rng, m, type_key, span, capacity=None):
    """A (type<<32|target) posting index over target position 0 of m link
    rows, padded to `capacity` as the store pads: keys with int64 max, perm
    and the targets rows with 0."""
    capacity = m + 48 if capacity is None else capacity
    targets = np.zeros((capacity, 2), np.int32)
    targets[:m] = rng.integers(0, span, (m, 2))
    keyarr = (np.int64(type_key) << 32) | targets[:m, 0].astype(np.int64)
    perm = np.zeros(capacity, np.int32)
    perm[:m] = np.argsort(keyarr, kind="stable")
    keys = np.full(capacity, np.iinfo(np.int64).max, np.int64)
    keys[:m] = keyarr[perm[:m]]
    return keys, perm, targets


@pytest.mark.parametrize("pairs,extra", [(((0, 0),), (1,)), (((1, 0), (0, 1)), ())])
def test_index_join_plain_matches_tpu_kernel(pairs, extra, layout):
    rng = np.random.default_rng(12)
    keys, perm, targets = _index_inputs(rng, 2000, 5, 40)
    lv, lm = _table(rng, 300, 2, 40)
    for cap in (3000, 256):
        if cap == 3000:
            _route(budget.index_join_plan(300, 2, 2048, 2048, 2, 2 + len(extra), cap),
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


# -- the multi-term probe and the 32-way search of csrc/probe.cu ---------------


def _probe_terms(rng):
    """18 terms (more than one launch's 16): int32 and int64 key columns,
    extra_fixed and eq_pairs, windows that fit and totals past capacity."""
    cols = {np.int32: _probe_inputs(rng, 2000, 3, np.int32, 3),
            np.int64: _probe_inputs(rng, 2000, 3, np.int64, 3)}
    terms = []
    for n in range(18):
        key_dtype, key, fvals, var_cols, eq_pairs, extra_fixed = PROBE_CASES[n % 3]
        keys, perm, targets = cols[key_dtype]
        terms.append(kernels.ProbeTerm(_t(keys), _t(perm), _t(targets), (key + n) % 3, fvals,
                                       3000 if n % 2 else 64, var_cols, eq_pairs,
                                       extra_fixed))
    return terms


def test_probe_term_tables_plain_matches_tpu_kernel(layout):
    terms = _probe_terms(np.random.default_rng(21))
    got = kernels.probe_term_tables(terms)
    assert len(got) == len(terms) > 16
    past_cap = 0
    for t, g in zip(terms, got):
        want = probe_term_table_impl(
            t.sorted_keys.numpy(), t.perm.numpy(), t.targets.numpy(),
            t.sorted_keys.numpy().dtype.type(t.probe_key), np.asarray(t.fixed_vals, np.int32),
            t.capacity, var_cols=t.var_cols, eq_pairs=t.eq_pairs, extra_fixed=t.extra_fixed,
            interpret=True)
        for w, x in zip(want, g):
            _same(w, x)
        past_cap += int(g[2]) > t.capacity
    assert past_cap > 0


def _warp_search(keys, q, upper):
    """csrc/probe.cu pr_search in Python: the answer lies in [lo, hi]; lane
    l reads keys[lo + (l + 1) * stride - 1], and the ballot of lanes still
    below q (upper: at or below) is a prefix of c lanes, which leaves
    [lo + c * stride, min(lo + (c + 1) * stride - 1, hi)].  Returns the
    bound and the number of dependent steps."""
    lo, hi, steps = 0, len(keys), 0
    while hi > lo:
        stride = (hi - lo + 31) >> 5
        below = []
        for lane in range(32):
            p = lo + (lane + 1) * stride - 1
            below.append(p < hi and (keys[p] <= q if upper else keys[p] < q))
        c = sum(below)
        assert below == [True] * c + [False] * (32 - c)   # the ballot is a prefix
        lo, hi = lo + c * stride, min(lo + (c + 1) * stride - 1, hi)
        steps += 1
    return lo, steps


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1023, 1025, 4095, 4097, (1 << 16) + 1])
def test_warp_search_mirror_matches_searchsorted(dtype, n):
    rng = np.random.default_rng(n)
    top = np.iinfo(dtype).max
    keys = np.sort(rng.integers(-40, 40, n)).astype(dtype)
    keys[n - n // 8:] = top          # capacity padding, as the store pads
    probes = [-41, -40, -1, 0, 7, 39, 40, top - 1, top] + keys[:: max(1, n // 16)].tolist()
    column = keys.tolist()
    for q in probes:
        for upper in (False, True):
            got, steps = _warp_search(column, int(q), upper)
            assert got == np.searchsorted(keys, dtype(q), side="right" if upper else "left")
            assert steps <= max(1, -(-int(np.log2(max(n, 2))) // 5) + 1)


# -- the sort-merge join without a sort (csrc/join_tables.cu), mirrored ---------

#: csrc/join_tables.cu JT_EMPTY: the set's empty-slot marker
JT_EMPTY = SENTINEL_L
_U64 = (1 << 64) - 1


def _key_ids(keys):
    """group.cuh's set of int64 keys in Python: 2^bits >= 2n slots (bits >=
    5), slot (key * 0x9E3779B97F4A7C15 mod 2^64) >> (64 - bits), linear
    probing, empty marker JT_EMPTY; dense ids in slot order, and a key equal
    to the marker takes the last id (the word after the slots).  Returns
    {key: id}."""
    bits = 5
    while (1 << bits) < 2 * len(keys):
        bits += 1
    slots = [JT_EMPTY] * (1 << bits)
    marked = False
    for k in keys:
        if k == JT_EMPTY:
            marked = True
            continue
        h = (((k & _U64) * 0x9E3779B97F4A7C15) & _U64) >> (64 - bits)
        while slots[h] not in (JT_EMPTY, k):
            h = (h + 1) % len(slots)
        slots[h] = k
    ids = {}
    for s in slots:
        if s != JT_EMPTY:
            ids[s] = len(ids)
    if marked:
        ids[JT_EMPTY] = len(ids)
    return ids


def _group_windows(key_l, key_r, regime):
    """Each left key's window (first grouped slot, count) and the right rows
    grouped stably by key, with no sort.  `block`: a set of the right keys,
    every right row placed by its id; `global` (group.cuh's engine): a set
    of the left keys, the right rows filtered by it."""
    if regime == "block":
        ids = _key_ids(key_r)
        rid = [ids[k] for k in key_r]
        lid = [ids.get(k, -1) for k in key_l]
    else:
        ids = _key_ids(key_l)
        lid = [ids[k] for k in key_l]
        rid = [ids.get(k, -1) for k in key_r]
    cnt = [0] * len(ids)
    for d in rid:
        if d >= 0:
            cnt[d] += 1
    start = np.concatenate([[0], np.cumsum(cnt)]).astype(int).tolist()
    base, grouped = list(start), [0] * start[-1]
    for j, d in enumerate(rid):          # in row order: the stable placement
        if d >= 0:
            grouped[base[d]] = j
            base[d] += 1
    lo = [start[d] if d >= 0 else 0 for d in lid]
    return lo, [cnt[d] if d >= 0 else 0 for d in lid], grouped


def _join_group_mirror(lv, lm, rv, rm, pairs, extra, cap, regime):
    """csrc/join_tables.cu in Python: mixed keys with the sentinels, the
    windows of _group_windows, the offsets (the scan of the counts, invalid
    left rows NOT masked), the slot expansion, the exact check of both
    masks and every pair, the emit [left | right_extra]."""
    n_l, n_r = lv.shape[0], rv.shape[0]
    out = np.zeros((cap, lv.shape[1] + len(extra)), np.int32)
    ov = np.zeros(cap, bool)
    total = 0
    if n_l and n_r:
        key_l = mix_columns(_t(lv), tuple(a for a, _ in pairs), _t(lm), SENTINEL_L).tolist()
        key_r = mix_columns(_t(rv), tuple(b for _, b in pairs), _t(rm), SENTINEL_R).tolist()
        lo, cnt, grouped = _group_windows(key_l, key_r, regime)
        offsets = np.cumsum(cnt)
        total = int(offsets[-1])
        for j in range(min(cap, total)):
            li = min(int(np.searchsorted(offsets, j, side="right")), n_l - 1)
            ri = grouped[lo[li] + j - (int(offsets[li]) - cnt[li])]
            if lm[li] and rm[ri] and all(lv[li, a] == rv[ri, b] for a, b in pairs):
                out[j] = np.concatenate([lv[li], rv[ri, list(extra)]])
                ov[j] = True
    return _t(out), _t(ov), torch.tensor(total, dtype=torch.int64)


def _join_cases():
    rng = np.random.default_rng(61)
    lv, lm = _table(rng, 300, 2, 30)
    rv, rm = _table(rng, 300, 2, 30)    # 300 rows over a span of 30: ties
    big_l, big_lm = _table(rng, 200, 2, 3000)
    big_r, big_rm = _table(rng, 20000, 2, 3000)
    one, two = ((0, 0),), ((0, 1), (1, 0))
    return {
        "one_pair": (lv, lm, rv, rm, one, (1,), 3000),
        "two_pairs": (lv, lm, rv, rm, two, (), 3000),
        "ties_total_past_cap": (lv, lm, rv, rm, one, (1,), 512),
        "all_invalid_left": (lv, lm & False, rv, rm, one, (1,), 3000),
        "all_invalid_right": (lv, lm, rv, rm & False, two, (), 3000),
        "one_left_row": (lv[:1], np.ones(1, bool), rv, rm, one, (1,), 64),
        "right_past_block_limit": (big_l, big_lm, big_r, big_rm, one, (1,), 4096),
    }


JOIN_CASES = _join_cases()


@pytest.mark.parametrize("regime", ["block", "global"])
@pytest.mark.parametrize("name", sorted(JOIN_CASES))
def test_join_group_mirror_matches_tpu_kernel(name, regime):
    lv, lm, rv, rm, pairs, extra, cap = JOIN_CASES[name]
    want = join_tables_impl(lv, lm, rv, rm, pairs, extra, cap, interpret=True)
    got = _join_group_mirror(lv, lm, rv, rm, pairs, extra, cap, regime)
    for w, g in zip(want, got):
        _same(w, g)
    if name == "ties_total_past_cap":
        assert int(got[2]) > cap
    if name == "right_past_block_limit":
        assert 0 < int(got[2]) <= cap


@pytest.mark.parametrize("regime", ["block", "global"])
def test_join_group_mirror_empty_right(regime):
    """A zero-row side joins to nothing: total 0, zeroed slots.  das_tpu's
    join kernel cannot gather from a zero-row side, so the port's plain
    version (tests/test_torch_ops.py test_join_tables_empty_side) is the
    reference here."""
    lv, lm, rv, rm, pairs, extra, cap = JOIN_CASES["one_pair"]
    args = (lv, lm, rv[:0], rm[:0], pairs, extra, 64)
    got = _join_group_mirror(*args, regime)
    want = kernels.join_tables_plain(*map(_t, args[:4]), pairs, extra, 64)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert int(got[2]) == 0 and not bool(got[1].any())


@pytest.mark.parametrize("regime", ["block", "global"])
def test_join_group_windows_sentinel_keys(regime):
    """Raw int64 keys with valid keys planted at 2^63-1 (the left sentinel
    and the set's empty marker), 2^63-2 (the right sentinel) and -2^63:
    every left key's window equals the reference prologue's (a stable
    argsort of the right keys and searchsorted, join.py _join_prologue)."""
    rng = np.random.default_rng(67)
    key_r = rng.integers(-6, 6, 400)
    key_l = rng.integers(-7, 7, 300)
    for keys in (key_r, key_l):
        keys[::7] = SENTINEL_L
        keys[1::11] = SENTINEL_R
        keys[2::13] = np.iinfo(np.int64).min
    lo, cnt, grouped = _group_windows(key_l.tolist(), key_r.tolist(), regime)
    order = np.argsort(key_r, kind="stable")
    want_lo = np.searchsorted(key_r[order], key_l, side="left")
    want_hi = np.searchsorted(key_r[order], key_l, side="right")
    for i in range(key_l.shape[0]):
        assert grouped[lo[i]:lo[i] + cnt[i]] == order[want_lo[i]:want_hi[i]].tolist()
    assert min(cnt[i] for i in range(0, 300, 7)) > 0      # 2^63-1 met 2^63-1


# -- the index join's one-block and grid designs (csrc/index_join.cu), mirrored --

#: csrc/index_join.cu: the block regime's cluster (blocks, threads a block),
#: the slots a thread expands per pass and the grid regime's block width
IJ_CLUSTER, IJ_CLUSTER_THREADS, IJ_SLOTS, IJ_GRID_THREADS = 8, 256, 2, 256


def _equal_range(keys, q):
    """ij_equal_range in Python: the lower and upper bound of q by two binary
    searches whose steps interleave; both end within ceil(log2(n + 1))
    steps."""
    l0, l1, h0, h1, steps = 0, len(keys), 0, len(keys), 0
    while l0 < l1 or h0 < h1:
        ml, mh = (l0 + l1) >> 1, (h0 + h1) >> 1
        if l0 < l1:
            l0, l1 = (ml + 1, l1) if keys[ml] < q else (l0, ml)
        if h0 < h1:
            h0, h1 = (mh + 1, h1) if keys[mh] <= q else (h0, mh)
        steps += 1
    assert steps <= max(1, len(keys)).bit_length()
    return l0, h0


def _block_scan(counts, threads):
    """das_block_scan in Python: each thread sums one contiguous chunk, the
    chunk sums are scanned across the block, each chunk then scans itself;
    all in uint64."""
    n = len(counts)
    per = -(-n // threads)
    out, run = [], 0
    for t in range(threads):
        for c in counts[t * per:(t + 1) * per]:
            run = (run + c) & _U64
            out.append(run)
    return out


def _grid_scan(counts, tile=2048):
    """das_scan_i64 in Python: a scan of each 2,048-count tile, the tile sums
    scanned by the same passes, then each tile's prefix added; uint64."""
    tiles = [_block_scan(counts[b:b + tile], 1) for b in range(0, len(counts), tile)]
    if len(tiles) <= 1:
        return tiles[0] if tiles else []
    sums = _grid_scan([t[-1] for t in tiles], tile)
    return [(v + (sums[b - 1] if b else 0)) & _U64 for b, t in enumerate(tiles) for v in t]


def _index_join_mirror(lv, lm, keys, perm, targets, type_key, pairs, right_var_cols, extra,
                       cap, regime):
    """csrc/index_join.cu in Python.  `block` (one cluster of 8 blocks):
    search k (row k // 2, the upper bound when k is odd) belongs to block
    k % 8, each the 32-way search of _warp_search, an invalid row
    unsearched; every block reads the bounds from their owners, scans the
    masked counts with its 256 threads and expands its share of each pass
    of 2 x 8 x 256 slots.  `global`: per row the interleaved binary
    searches, the device-wide scan, the expand grid.  Each slot: its left
    row by an upper bound over the offsets, its key lo + j - prev, perm and
    targets clipped, the pairs after the first checked, [left |
    right_extra]."""
    n_left, kl = lv.shape
    n_keys, n_rows = keys.shape[0], targets.shape[0]
    column = keys.tolist()
    lo, hi = [0] * n_left, [0] * n_left
    if regime == "block":
        found = [{} for _ in range(IJ_CLUSTER)]     # each block's shared bounds
        for k in range(2 * n_left):
            i = k >> 1
            if lm[i]:
                q = (type_key << 32) | int(lv[i, pairs[0][0]])   # sign-extended
                found[k % IJ_CLUSTER][k] = _warp_search(column, q, bool(k & 1))[0]
        for i in range(n_left):
            if lm[i]:
                lo[i] = found[(2 * i) % IJ_CLUSTER][2 * i]
                hi[i] = found[(2 * i + 1) % IJ_CLUSTER][2 * i + 1]
    else:
        for i in range(n_left):
            if lm[i]:
                lo[i], hi[i] = _equal_range(column, (type_key << 32) | int(lv[i, pairs[0][0]]))
    counts = [h - l if m else 0 for l, h, m in zip(lo, hi, lm)]
    offsets = (_block_scan(counts, IJ_CLUSTER_THREADS) if regime == "block"
               else _grid_scan(counts))
    total = offsets[-1] if n_left else 0
    out = np.zeros((cap, kl + len(extra)), np.int32)
    ov = np.zeros(cap, bool)
    lanes = (IJ_CLUSTER * IJ_CLUSTER_THREADS if regime == "block"
             else IJ_GRID_THREADS * -(-cap // (IJ_SLOTS * IJ_GRID_THREADS)))
    tile = IJ_SLOTS * lanes
    for j0 in range(0, cap, tile):
        for j in range(j0, min(j0 + tile, cap, total)):
            li = min(int(np.searchsorted(offsets, j, side="right")), n_left - 1)
            prev = offsets[li - 1] if li else 0
            ri = min(max(lo[li] + j - prev, 0), n_keys - 1)
            row = targets[min(max(int(perm[ri]), 0), n_rows - 1)]
            if all(row[right_var_cols[rc]] == lv[li, lc] for lc, rc in pairs[1:]):
                out[j] = np.concatenate([lv[li], row[[right_var_cols[rc] for rc in extra]]])
                ov[j] = True
    return _t(out), _t(ov), torch.tensor(total, dtype=torch.int64)


def _index_cases():
    rng = np.random.default_rng(71)
    keys, perm, targets = _index_inputs(rng, 2000, 5, 40)
    lv, lm = _table(rng, 300, 2, 40)            # ~50 keys a value: 300 rows pass cap
    skew_keys, skew_perm, skew_targets = _index_inputs(rng, 2000, 5, 4)   # ~500 a value
    few = (lv[:50], lm[:50])                    # a total below cap: slots past it zeroed
    negative = few[0].copy()
    negative[::5, 0] = -rng.integers(1, 40, negative[::5].shape[0])
    one, two = ((0, 0),), ((0, 0), (1, 1))
    index = (keys, perm, targets, 5)
    return {
        "one_pair": (*few, *index, one, (0, 1), (1,), 3000),
        "total_past_cap": (lv, lm, *index, one, (0, 1), (1,), 256),
        "window_past_cap": (lv[:4], np.ones(4, bool), skew_keys, skew_perm, skew_targets, 5,
                            one, (0, 1), (1,), 256),
        "all_invalid_left": (lv, lm & False, *index, one, (0, 1), (1,), 3000),
        "negative_join_value": (negative, few[1] | True, *index, one, (0, 1), (1,), 3000),
        "failing_second_pair": (*few, *index, two, (0, 1), (), 3000),
        "no_right_extra": (*few, *index, one, (0, 1), (), 3000),
        "one_left_row": (lv[:1], np.ones(1, bool), *index, one, (0, 1), (1,), 64),
    }


INDEX_CASES = _index_cases()


@functools.lru_cache(maxsize=None)
def _index_reference(name, layout):
    lv, lm, keys, perm, targets, tk, pairs, rvc, extra, cap = INDEX_CASES[name]
    return index_join_impl(lv, lm, keys, perm, targets, np.int64(tk), pairs, rvc, extra, cap,
                           interpret=True)


@pytest.mark.parametrize("regime", ["block", "global"])
@pytest.mark.parametrize("name", sorted(INDEX_CASES))
def test_index_join_mirror_matches_tpu_kernel(name, regime, layout):
    args = INDEX_CASES[name]
    got = _index_join_mirror(*args, regime)
    for w, g in zip(_index_reference(name, layout), got):
        _same(w, g)
    total, valid = int(got[2]), int(got[1].sum())
    if name.endswith("past_cap"):
        assert total > args[-1]
    elif name == "all_invalid_left":
        assert total == 0
    elif name == "failing_second_pair":
        assert 0 < valid < total < args[-1]       # failed slots count in the total
    else:
        assert valid == total < args[-1]
    if name == "negative_join_value":            # the sign-extended probes find nothing
        lv, lm = args[:2]
        masked = _index_join_mirror(lv, lm & (lv[:, 0] >= 0), *args[2:], regime)
        assert total == int(masked[2]) and bool((got[0][:, 0] >= 0).all())
