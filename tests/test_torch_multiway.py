"""Kernel 5 (the k-way star join) of the port against the JAX package.

`multiway_join_plain` — what the port's wrapper runs on a CPU tensor — is
held bit for bit against `das_tpu`'s `multiway_join_impl(...,
interpret=True)`, in the single-block and the grid-chunked layout (forced
through the JAX bytes planner's DAS_TPU_VMEM_BUDGET), on random stars with
tied keys and on the parity traps.  Then the fused multiway path end to
end: the port's executor against `das_tpu`'s on the bio configurations of
tests/test_zmultiway.py, under use_multiway "on", "auto" and "off"."""

import numpy as np
import pytest
import torch

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.kernels import budget
from das_tpu.kernels.multiway import multiway_join_impl
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query.fused import get_executor as jx_executor
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch import kernels, planner
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query.fused import get_executor
from das_tpu_torch.storage.tensor_db import TensorDB


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _table(rng, n, k, span, p_valid=0.8):
    vals = rng.integers(0, span, (n, k)).astype(np.int32)
    valid = rng.random(n) < p_valid
    vals[~valid] = 0
    return vals, valid


def _star(rng, n_left, widths, span, rows=200, vcol0=1, p_left=0.8):
    """A left table and one tail per width; each tail's v column is random
    and every other column is an extra."""
    left = _table(rng, n_left, 2, span, p_left)
    tails, meta = [], []
    for w in widths:
        tails.append(_table(rng, rows, w, span))
        vcol = int(rng.integers(0, w))
        meta.append((vcol, tuple(c for c in range(w) if c != vcol)))
    return left, tails, tuple(meta), vcol0


def _both(left, tails, meta, vcol0, cap):
    want = multiway_join_impl(left[0], left[1], tails, vcol0, meta, cap, interpret=True)
    got = kernels.multiway_join(_t(left[0]), _t(left[1]), [(_t(v), _t(m)) for v, m in tails],
                                vcol0, meta, cap)
    for w, g in zip(want, got):
        _same(w, g)
    return got


def _plan(left, tails, meta, cap):
    kpad = max(v.shape[1] for v, _ in tails)
    k_out = left[0].shape[1] + sum(len(e) for _v, e in meta)
    return budget.multiway_plan(left[0].shape[0], left[0].shape[1],
                                tuple((v.shape[0], kpad) for v, _ in tails), k_out, cap)


@pytest.mark.parametrize("layout", ["single", "tiled"])
@pytest.mark.parametrize("widths", [(2,), (2, 3), (3, 1, 2)], ids=["k2", "k3", "k4"])
def test_multiway_plain_matches_tpu_kernel(widths, layout, monkeypatch):
    monkeypatch.delenv("DAS_TPU_VMEM_BUDGET", raising=False)
    rng = np.random.default_rng(20 + len(widths))
    # several tail rows per key, so ties decide the layout; the product
    # of the windows stays inside the capacity
    rows, span = (200, 7) if len(widths) == 1 else (60, 20)
    left, tails, meta, vcol0 = _star(rng, 150, widths, span, rows=rows)
    cap = 3000
    plan = _plan(left, tails, meta, cap)
    if layout == "tiled":
        # just above the tiled resident set + one 1024-row chunk
        per_row = plan.block_bytes // cap
        monkeypatch.setenv("DAS_TPU_VMEM_BUDGET",
                           str(plan.resident_bytes + per_row * budget.MIN_CHUNK_ROWS + 64))
        plan = _plan(left, tails, meta, cap)
        assert plan.route == budget.ROUTE_TILED and -(-cap // plan.chunk_rows) > 1
    else:
        assert plan.route == budget.ROUTE_SINGLE
    got = _both(left, tails, meta, vcol0, cap)
    assert 0 < int(got[2][-1]) <= cap and int(got[1].sum()) > 0
    # totals past capacity: the exact totals, the first cap slots
    got = _both(left, tails, meta, vcol0, 64)
    assert int(got[2][-1]) > 64


def _trap_cases():
    rng = np.random.default_rng(31)
    cases = {}
    left, tails, meta, v0 = _star(rng, 80, (2, 2), 5)
    cases["all_invalid_left"] = ((left[0] * 0, left[1] & False), tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 80, (2, 2), 5)
    # disjoint key ranges: the intersection is empty, every total 0
    tails = [(v + 100, m) for v, m in tails]
    cases["empty_intersection"] = (left, tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 1, (2, 3), 3, rows=40)
    left = (np.full_like(left[0], 1), np.ones(1, bool))
    cases["one_left_row"] = (left, tails, meta, v0, 512)
    left, tails, meta, v0 = _star(rng, 90, (1, 2), 6)
    cases["tail_without_extras"] = (left, tails, ((0, ()), meta[1]), v0, 1024)
    left, tails, meta, v0 = _star(rng, 60, (2, 2, 2), 2, rows=60)
    cases["all_tied_past_capacity"] = (left, tails, meta, v0, 100)
    return cases


TRAPS = _trap_cases()


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_multiway_traps_match_tpu_kernel(name, monkeypatch):
    monkeypatch.delenv("DAS_TPU_VMEM_BUDGET", raising=False)
    left, tails, meta, v0, cap = TRAPS[name]
    got = _both(left, tails, meta, v0, cap)
    totals = got[2].tolist()
    if name in ("all_invalid_left", "empty_intersection"):
        assert totals == [0] * len(tails) and not bool(got[1].any())
    if name == "all_tied_past_capacity":
        assert totals[-1] > cap


def test_multiway_wraparound_matches_tpu_kernel():
    """Four tails of 2^16 rows on one key: the window product 2^64 wraps
    to 0 in int64, as it does in XLA."""
    n = 1 << 16
    tail = (np.zeros((n, 1), np.int32), np.ones(n, bool))
    left = (np.zeros((1, 2), np.int32), np.ones(1, bool))
    got = _both(left, [tail] * 4, ((0, ()),) * 4, 0, 16)
    assert got[2].tolist() == [1 << 16, 1 << 32, 1 << 48, 0]


def test_multiway_zero_row_sides():
    """das_tpu cannot gather from a zero-row left side or tail (jnp.take
    from an empty axis raises); the port answers total 0 and zeroed slots."""
    rng = np.random.default_rng(41)
    left, tails, meta, v0 = _star(rng, 30, (2, 2), 4)
    cases = [
        ((left[0][:0], left[1][:0]), tails),
        (left, [tails[0], (tails[1][0][:0], tails[1][1][:0])]),
    ]
    for lt, ts in cases:
        with pytest.raises(IndexError):
            multiway_join_impl(lt[0], lt[1], ts, v0, meta, 32, interpret=True)
        out, ov, tot = kernels.multiway_join(
            _t(lt[0]), _t(lt[1]), [(_t(v), _t(m)) for v, m in ts], v0, meta, 32)
        assert int(tot[-1]) == 0 and not bool(ov.any())
        assert out.shape == (32, 4) and not bool(out.any())


# -- the fused multiway path end to end ------------------------------------


BIO = dict(n_genes=60, n_processes=15, members_per_gene=4, n_interactions=80, seed=7)
SKEW = dict(n_genes=120, n_processes=40, members_per_gene=3, n_interactions=0, seed=17,
            skew=1.1)


def _no_env(monkeypatch):
    # the config decides the arm, and learned capacities must not come
    # from another process's cache
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_VMEM_BUDGET",
                "DAS_TPU_PLANNER_DP_MAX"):
        monkeypatch.delenv(var, raising=False)


def _suite(mod, gene_names):
    L, V, N = mod.Link, mod.Variable, mod.Node
    g0, g1 = gene_names[:2]
    return [
        mod.And([L("Member", [V("V1"), V("V3")], True), L("Member", [V("V2"), V("V3")], True),
                 L("Member", [V("V4"), V("V3")], True)]),
        mod.And([L("Member", [V("V1"), V("V3")], True), L("Member", [V("V2"), V("V3")], True),
                 L("Interacts", [V("V1"), V("V2")], True)]),
        mod.And([L("Member", [N("Gene", g0), V("V3")], True),
                 L("Member", [V("V2"), V("V3")], True),
                 L("Interacts", [N("Gene", g0), V("V2")], True)]),
        mod.And([L("Member", [V("V2"), V("V3")], True),
                 L("Member", [N("Gene", g1), V("V3")], True),
                 mod.Not(L("Interacts", [N("Gene", g1), V("V2")], True))]),
    ]


def _jx_run(db, plans):
    """das_tpu's fused executor to settle: (stats, host vals, host valid,
    rounds, multiway)."""
    job = jx_executor(db)._exec_job(plans, False)
    while True:
        out = job.dispatch()
        host = tuple(np.asarray(x) for x in out)
        if job.settle(host, out):
            r = job.result
            return host[2], r.host_vals, r.host_valid, job.rounds, r.multiway


def _pairs(kw, mode):
    jdata, genes, _ = jx_bio(**kw)
    pdata, _, _ = build_bio_atomspace(**kw)
    jdb = JxTensorDB(jdata, JxConfig(use_multiway=mode))
    pdb = TensorDB(pdata, DasConfig(use_multiway=mode), device="cpu")
    names = [jdata.nodes[h].name for h in genes]
    return jdb, pdb, names


@pytest.mark.parametrize("mode", ["on", "auto", "off"])
def test_fused_multiway_path_matches_das_tpu(mode, monkeypatch):
    _no_env(monkeypatch)
    jdb, pdb, names = _pairs(BIO, mode)
    compiler.reset_route_counts()
    n_multiway = 0
    for jq, pq in zip(_suite(jx_ast, names), _suite(ast, names)):
        jplans = jx_compiler.plan_query(jdb, jq)
        pplans = compiler.plan_query(pdb, pq)
        for _ in range(2):   # the second run starts from the learned caps
            stats, vals, valid, rounds, mw = _jx_run(jdb, jplans)
            res = get_executor(pdb).execute(pplans)
            assert res.stats.tolist() == stats.tolist()
            assert np.array_equal(res.host_vals, vals)
            assert np.array_equal(res.host_valid, valid)
            assert (res.rounds, res.multiway) == (rounds, mw)
            n_multiway += mw
    assert compiler.ROUTE_COUNTS["fused_multiway"] == n_multiway
    if mode == "on":
        assert n_multiway == 8    # every query of the suite has a star prefix
    if mode == "off":
        assert n_multiway == 0


def test_skew_star_settles_in_one_round():
    """The 3-clause star on the skewed KB: the multiway step's one buffer
    seeds from the exact k-way product, so it settles in round 0 with the
    estimate equal to the actual, as tests/test_zmultiway.py pins for
    das_tpu."""
    data, genes, _ = build_bio_atomspace(**SKEW)
    pdb = TensorDB(data, DasConfig(use_multiway="auto"), device="cpu")
    names = [data.nodes[h].name for h in genes]
    pplans = compiler.plan_query(pdb, _suite(ast, names)[0])
    planned = planner.plan_conjunction(pdb, pplans)
    assert planned.multiway == 3 and planned.route == "fused_multiway"
    planner.reset_planner_counts()
    res = get_executor(pdb).execute(pplans, count_only=True)
    assert res.rounds == 1 and res.multiway
    snap = planner.snapshot()
    assert snap["round0"] == 1 and snap["retries"] == 0
    assert snap["actual_vs_est_ratio"] == 1.0


# -- the algorithm of csrc/multiway.cu's regimes, mirrored ---------------

I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _mix1(v):
    """The mix of one int32 column (ops/join.py mix_columns, one column)."""
    x = torch.as_tensor(np.asarray(v)).to(torch.int64)
    return x ^ (x >> 29)


def _filter_group_mirror(left, tails, meta, vcol0, cap):
    """csrc/multiway.cu's regimes (block, filter, global) in PyTorch: no tail is
    sorted.  The set of the left's valid mixed v keys gets dense ids; each
    tail row survives iff it is valid and its mixed key is in the set; the
    survivors, in (tail, row) order, are grouped stably by the bin
    id * T + t (what the kernels' count, scan and place passes build); a
    left row's window in tail t is its bin's run of survivors.  Then the
    products, totals, offsets and the mixed-radix expansion, which stops at
    an empty window (that slot is invalid in the reference too)."""
    lv, lm = _t(left[0]), _t(left[1])
    n_left, n_tails = lv.shape[0], len(tails)
    lkey = _mix1(left[0][:, vcol0])
    keys = torch.unique(lkey[lm])
    lid = torch.where(lm, torch.searchsorted(keys, lkey), -1)
    bins, rows = [], []
    for t, ((tv, tm), (vcol, _e)) in enumerate(zip(tails, meta)):
        tkey = _mix1(tv[:, vcol])
        alive = _t(tm) & torch.isin(tkey, keys)
        bins.append(torch.searchsorted(keys, tkey[alive]) * n_tails + t)
        rows.append(torch.nonzero(alive).flatten())
    bins, rows = torch.cat(bins), torch.cat(rows)
    grouped = rows[torch.argsort(bins, stable=True)]
    counts = torch.bincount(bins, minlength=max(n_left * n_tails, 1))
    starts = torch.cumsum(counts, 0) - counts
    run = torch.ones(n_left, dtype=torch.int64)
    lo, cnt, totals = [], [], []
    for t in range(n_tails):
        b = (lid * n_tails + t).clamp(min=0)
        c = torch.where(lid >= 0, counts[b], 0)
        lo.append(starts[b])
        cnt.append(c)
        run = run * c
        totals.append(run.sum())
    offsets = torch.cumsum(run, 0)
    total = int(totals[-1])
    k_out = lv.shape[1] + sum(len(e) for _v, e in meta)
    out = torch.zeros((cap, k_out), dtype=torch.int32)
    ov = torch.zeros(cap, dtype=torch.bool)
    for j in range(min(cap, max(total, 0))):
        li = min(int(torch.searchsorted(offsets, torch.tensor(j), right=True)), n_left - 1)
        rem = j - (int(offsets[li]) - int(run[li]))
        picked = [None] * n_tails
        valid = bool(lm[li])
        for t in range(n_tails - 1, -1, -1):
            c = int(cnt[t][li])
            off, rem = rem % max(c, 1), rem // max(c, 1)
            if not valid or c == 0:
                valid = False
                break
            r = int(grouped[int(lo[t][li]) + off])
            tv, tm = tails[t]
            valid = bool(tm[r]) and tv[r, meta[t][0]] == left[0][li, vcol0]
            picked[t] = r
        if valid:
            out[j] = torch.from_numpy(np.concatenate(
                [left[0][li]] + [tails[t][0][picked[t], list(meta[t][1])]
                                 for t in range(n_tails)]).astype(np.int32))
            ov[j] = True
    return out, ov, torch.stack(totals)


def _mirror_cases():
    rng = np.random.default_rng(47)
    cases = {}
    left, tails, meta, v0 = _star(rng, 60, (2, 3), 9, rows=120)
    left[0][:, v0] = -left[0][:, v0] - 1
    left[0][:4, v0] = I32_MIN, I32_MAX, I32_MIN, -1
    for v, _m in tails:
        v[:, :] = -v - 1
        v[:6] = I32_MIN
        v[6:12] = I32_MAX
    cases["negative_and_extreme_v"] = (left, tails, meta, v0, 4096)
    left, tails, meta, v0 = _star(rng, 50, (2, 2), 6)
    for v, m in tails:
        v[~m, meta[0][0]] = left[0][0, v0]   # masked rows that hold a left value
    cases["masked_rows_equal_a_left_value"] = (left, tails, meta, v0, 4096)
    left, tails, meta, v0 = _star(rng, 50, (2, 2), 6)
    for (v, _m), (vcol, _e) in zip(tails, meta):
        flip = rng.random(v.shape[0]) < 0.5
        v[flip, vcol] = ~v[flip, vcol]        # mix(~v) == mix(v): keys collide
    cases["v_and_not_v_collide"] = (left, tails, meta, v0, 4096)
    left, tails, meta, v0 = _star(rng, 70, (2, 2), 5, p_left=0.5)
    cases["invalid_left_rows"] = (left, tails, meta, v0, 4096)
    left, tails, meta, v0 = _star(rng, 40, (2, 2), 5)
    tails[1] = (tails[1][0] + 100, tails[1][1])
    cases["zero_count_tail"] = (left, tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 40, (2, 2, 2), 2, rows=40)
    cases["ties_past_capacity"] = (left, tails, meta, v0, 100)
    left, tails, meta, v0 = _star(rng, 40, (4, 3), 5)
    cases["wide_tails"] = (left, tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 40, (2,), 5)
    cases["single_tail"] = (left, tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 40, (2, 2), 5)
    cases["empty_intersection"] = (left, [(v + 100, m) for v, m in tails], meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 30, (2, 2), 5)
    cases["all_left_invalid"] = ((left[0], left[1] & False), tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 8, (2,) * 26, 2, rows=4)
    cases["more_tails_than_kernel_parameters"] = (left, tails, meta, v0, 512)
    left, tails, meta, v0 = _star(rng, 1, (2, 2), 3, rows=30, p_left=1.0)
    cases["one_left_row"] = (left, tails, meta, v0, 256)
    left, tails, meta, v0 = _star(rng, 200, (2, 2), 3, rows=60)
    cases["many_left_rows_share_a_key"] = (left, tails, meta, v0, 512)
    return cases


MIRROR = _mirror_cases()


@pytest.mark.parametrize("name", sorted(MIRROR))
def test_filter_group_mirror_matches_tpu_kernel(name, monkeypatch):
    monkeypatch.delenv("DAS_TPU_VMEM_BUDGET", raising=False)
    left, tails, meta, v0, cap = MIRROR[name]
    want = multiway_join_impl(left[0], left[1], tails, v0, meta, cap, interpret=True)
    got = _filter_group_mirror(left, tails, meta, v0, cap)
    for w, g in zip(want, got):
        _same(w, g)
    totals = got[2].tolist()
    if name == "zero_count_tail":
        assert totals[1] == 0 and totals[0] > 0
    if name == "ties_past_capacity":
        assert totals[-1] > cap
    if name == "v_and_not_v_collide":
        # colliding rows count in the totals, then fail the exact check
        assert totals[-1] > int(got[1].sum())


def test_filter_group_mirror_wraparound():
    """Four tails of 2^16 rows on one key: the product 2^64 wraps to 0."""
    n = 1 << 16
    tail = (np.zeros((n, 1), np.int32), np.ones(n, bool))
    left = (np.zeros((1, 2), np.int32), np.ones(1, bool))
    out, ov, tot = _filter_group_mirror(left, [tail] * 4, ((0, ()),) * 4, 0, 16)
    assert tot.tolist() == [1 << 16, 1 << 32, 1 << 48, 0]
    assert not bool(ov.any())


def test_mix_facts_the_filter_rests_on():
    """mix(~v) == mix(v), and every int32's mix lies in [0, 2^31), below
    both sentinels (2^63-1, 2^63-2): the two facts that let the multiway
    kernel filter tails by mixed key instead of sorting them."""
    from das_tpu.ops.join import _mix_columns
    from das_tpu_torch.ops.join import SENTINEL_L, SENTINEL_R, mix_columns

    rng = np.random.default_rng(53)
    v = np.concatenate([rng.integers(I32_MIN, I32_MAX, 4096, endpoint=True),
                        [I32_MIN, -1, 0, I32_MAX]]).astype(np.int32)
    ones = torch.ones(v.shape[0], dtype=torch.bool)
    key = mix_columns(_t(v[:, None]), (0,), ones, SENTINEL_L)
    assert torch.equal(key, mix_columns(_t(~v[:, None]), (0,), ones, SENTINEL_L))
    assert torch.equal(key, _mix1(v))
    assert np.array_equal(key.numpy(), np.asarray(_mix_columns(v[:, None], (0,), np.ones(
        v.shape[0], bool), SENTINEL_L)))
    assert int(key.min()) >= 0 and int(key.max()) < 1 << 31
    assert int(key.max()) < SENTINEL_R < SENTINEL_L
