#!/usr/bin/env python3
"""Smoke run of das_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--scale S] [--seed N]

Phases, one JSON line each:

  1. card    — the card's name and power limit (nvidia-smi), then the
               build of the hand-written CUDA kernels from csrc/ with their
               `-Xptxas -v` register / shared-memory / spill report;
  2. kernels — every kernel against its plain PyTorch version on the same
               CUDA tensors, exact: the main path's own inputs plus a
               whole-type probe window of >= 2^21 rows, totals past
               capacity, tied join keys, an empty side, int32 and int64
               probe keys; times from CUDA events;
  3. slice   — the main path through the public API: a FlyBase-shaped
               knowledge base (SimplePatternMiner.ipynb cell 0, cut by
               --scale) in DistributedAtomSpace(backend="tensor") on the
               card, answering 32 grounded 3-clause queries, their 32 Not
               variants and the all-variable triangle (on the LARGE bio
               configuration; at FlyBase shape it needs ~3.2e9 rows).  The
               launch counters are zeroed just before and read just after.
               Answers are then checked: every FlyBase answer against a
               numpy evaluation of the same query over the host store;
               sampled grounded / Not answers on LARGE against the host
               algebra (the "memory" backend); the LARGE triangle count
               against numpy; the triangle's answer set on the SMALL
               configuration against the host algebra.

Then a line {"kernels": [...]} with each kernel's route, source, the TPU
kernel it replaces, launches on the main path, error against the plain
version, its time, the plain version's, the bound and a library call's
time where one PyTorch call computes the same function; and last
{"ok": true, "device": {...}}.  Any mismatch raises: the exit code is then
non-zero and no result line is printed.  Without a CUDA card, or without
the das_tpu_torch package beside it, the script exits non-zero."""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import subprocess
import sys
import time

import numpy as np

#: where the slice runs; "cuda" always when run as a script
DEVICE = "cuda"

#: the reference baseline KB: 2,584,508 nodes / 27,871,440 links
#: (SimplePatternMiner.ipynb cell 0); bench.py FLYBASE
FLYBASE = dict(n_genes=2_400_000, n_processes=180_000, members_per_gene=10,
               n_interactions=1_500_000, n_evaluations=435_000)
#: bench.py LARGE and SMALL
LARGE = dict(n_genes=20000, n_processes=2000, members_per_gene=5,
             n_interactions=15000, n_evaluations=5000)
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5,
             n_interactions=300, n_evaluations=0)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (fp32 figure)

TPU_KERNELS = {
    "probe": ("das_tpu_torch/kernels/csrc/probe.cu", "das_tpu/kernels/probe.py:127"),
    "index_join": ("das_tpu_torch/kernels/csrc/index_join.cu", "das_tpu/kernels/join.py:342"),
    "join_tables": ("das_tpu_torch/kernels/csrc/join_tables.cu", "das_tpu/kernels/join.py:234"),
    "anti_join": ("das_tpu_torch/kernels/csrc/anti_join.cu", "das_tpu/kernels/join.py:399"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scaled(cfg, scale):
    return {k: (v if k == "members_per_gene" else max(1, int(v * scale)))
            for k, v in cfg.items()}


def cuda_ms(fn, iters: int) -> float:
    """Mean time of one call from CUDA events around `iters` calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(want, got) -> int:
    """Largest absolute difference over every output of a call (0 = exact)."""
    import torch

    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    err = 0
    for w, g in zip(want, got):
        if w.shape != g.shape or w.dtype != g.dtype:
            raise AssertionError(f"shape/dtype mismatch {w.shape}/{w.dtype} vs {g.shape}/{g.dtype}")
        if w.numel():
            err = max(err, int((w.to(torch.int64) - g.to(torch.int64)).abs().max()))
    return err


# ---- phase 1 ---------------------------------------------------------------------


def phase_card():
    import torch

    from das_tpu_torch.kernels import launch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    so = launch.build()
    lib = launch.library()
    build_s = time.perf_counter() - t0
    report = [
        line.strip() for line in launch.ptxas_report().splitlines()
        if "registers" in line or "spill" in line or line.startswith("==")
        or "Compiling entry" in line
    ]
    for line in report:
        print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "library": so.name, "build_s": build_s,
          "loaded": lib is not None})
    return smi


# ---- knowledge bases -------------------------------------------------------------


def build_kb(cfg, seed):
    from das_tpu_torch.models.bio import build_bio_atomspace

    data, genes, _procs = build_bio_atomspace(seed=seed, **cfg)
    return data, genes


class HostKB:
    """Host-side numpy view of the Member / Interacts links of a finalized
    store: the independent reference the device answers are held to."""

    def __init__(self, data, gene_handles):
        fin = data.finalize()
        b = fin.buckets[2]
        tid = {name: fin.type_id_of_hash[data.table.get_named_type_hash(name)]
               for name in ("Member", "Interacts")}
        self.fin = fin
        mem = b.targets[b.type_id == tid["Member"]]
        inter = b.targets[b.type_id == tid["Interacts"]]
        self.member = mem            # [m, 2] (gene row, process row)
        self.interacts = inter       # [i, 2] (gene row, gene row)
        self.gene_rows = np.asarray([fin.row_of_hex[h] for h in gene_handles])
        order = np.argsort(mem[:, 0], kind="stable")
        self.mem_by_gene = mem[order]
        order = np.argsort(mem[:, 1], kind="stable")
        self.mem_by_proc = mem[order]
        order = np.argsort(inter[:, 0], kind="stable")
        self.inter_by_a = inter[order]

    @staticmethod
    def _rows(sorted_pairs, col, key):
        lo = np.searchsorted(sorted_pairs[:, col], key, side="left")
        hi = np.searchsorted(sorted_pairs[:, col], key, side="right")
        return sorted_pairs[lo:hi]

    def procs(self, g):
        return self._rows(self.mem_by_gene, 0, g)[:, 1]

    def members(self, p):
        return self._rows(self.mem_by_proc, 1, p)[:, 0]

    def partners(self, g):
        return self._rows(self.inter_by_a, 0, g)[:, 1]

    def grounded(self, g, negate: bool):
        """{(V2, V3)} of And(Member(g, V3), Member(V2, V3), [Not] Interacts(g, V2))."""
        partners = set(self.partners(g).tolist())
        out = set()
        for p in self.procs(g).tolist():
            for v2 in self.members(p).tolist():
                if (v2 in partners) != negate:
                    out.add((v2, p))
        return out

    def nonempty_genes(self):
        """Gene rows whose grounded answer is non-empty: an interaction
        partner shares a process."""
        width = int(np.bincount(self.member[:, 0]).max())
        n_rows = int(self.fin.atom_count)
        table = np.full((n_rows, width), -1, dtype=np.int64)
        starts = np.searchsorted(self.mem_by_gene[:, 0], self.mem_by_gene[:, 0], side="left")
        slot = np.arange(self.mem_by_gene.shape[0]) - starts
        table[self.mem_by_gene[:, 0], slot] = self.mem_by_gene[:, 1]
        a, b = table[self.interacts[:, 0]], table[self.interacts[:, 1]]
        shared = ((a[:, :, None] == b[:, None, :]) & (a[:, :, None] >= 0)).any(axis=(1, 2))
        return np.unique(self.interacts[shared, 0])

    def triangle_count(self):
        """|{(V1, V2, V3)}| of the triangle: per Interacts link (a, b) the
        processes a and b share."""
        total = 0
        for a, b in self.interacts.tolist():
            total += len(set(self.procs(a).tolist()) & set(self.procs(b).tolist()))
        return total


def grounded_query(gene_name, negate=False):
    from das_tpu_torch.query.ast import And, Link, Node, Not, Variable

    third = Link("Interacts", [Node("Gene", gene_name), Variable("V2")], True)
    return And([
        Link("Member", [Node("Gene", gene_name), Variable("V3")], True),
        Link("Member", [Variable("V2"), Variable("V3")], True),
        Not(third) if negate else third,
    ])


def triangle_query():
    from das_tpu_torch.query.ast import And, Link, Variable

    return And([
        Link("Member", [Variable("V1"), Variable("V3")], True),
        Link("Member", [Variable("V2"), Variable("V3")], True),
        Link("Interacts", [Variable("V1"), Variable("V2")], True),
    ])


def answer_rows(das, query):
    """(matched, {(V2 row, V3 row)}) of a grounded-shape answer."""
    matched, answer = das.query_answer(query)
    row = das.db.fin.row_of_hex
    return matched, {(row[a.mapping["V2"]], row[a.mapping["V3"]]) for a in answer.assignments}


def answer_set(das, query):
    matched, answer = das.query_answer(query)
    return bool(matched), {frozenset(a.mapping.items()) for a in answer.assignments}


# ---- phase 2 ---------------------------------------------------------------------


def bytes_bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_inputs(das, gene_name):
    """The exact kernel calls the fused executor makes for one grounded
    query and its Not variant, at the capacities it settled on."""
    from das_tpu_torch import kernels
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.fused import fold_join_meta, get_executor

    calls = {}
    ex = get_executor(das.db)
    for negate in (False, True):
        q = grounded_query(gene_name, negate)
        das.query_answer(q)                      # settles and learns the capacities
        plans = compiler.plan_query(das.db, q)
        job = ex._exec_job(plans)
        positives, _neg, _names, join_meta, anti_meta = fold_join_meta(job.sigs)
        tables = {}
        for i, t in enumerate(job.sigs):
            if i in job.index_right:
                continue
            ks, perm, targets, _tid = job.arrays[i]
            args = (ks, perm, targets, job.keys[i], job.fvals[i], job.term_caps[i])
            kw = dict(var_cols=t.var_cols, eq_pairs=t.eq_pairs, extra_fixed=t.extra_fixed)
            calls.setdefault("probe", (args, kw))
            vals, mask, _ = kernels.probe_term_table_plain(*args, **kw)
            tables[i] = (vals, mask)
        acc = tables[positives[0]]
        for t, i in enumerate(positives[1:]):
            pairs, extra = join_meta[t]
            jc = job.join_caps[t]
            if job.index_joins[t] >= 0:
                ks, perm, targets, _tid = job.arrays[i]
                args = (*acc, ks, perm, targets, int(job.keys[i]), pairs,
                        job.sigs[i].var_cols, extra, jc)
                calls.setdefault("index_join", (args, {}))
                out = kernels.index_join_plain(*args)
            else:
                args = (*acc, *tables[i], pairs, extra, jc)
                calls.setdefault("join_tables", (args, {}))
                out = kernels.join_tables_plain(*args)
            acc = out[:2]
        for i, pairs in anti_meta:
            calls.setdefault("anti_join", ((*acc, *tables[i], pairs), {}))
    return calls


def work_of(name, args, kw, out):
    """(bytes, operations) the call's data needs: every input it must read
    once, every output written once; a probe or index join reads only the
    posting-index window its keys select."""

    def nb(t):
        return t.numel() * t.element_size()

    if name == "probe":
        ks, perm, targets, _key, _f, cap = args
        window = min(int(out[2]), cap)
        arity = targets.shape[1]
        steps = 2 * max(1, math.ceil(math.log2(max(ks.numel(), 2))))
        n_bytes = steps * ks.element_size() + window * 4 * (1 + arity) + nb(out[0]) + nb(out[1]) + 4
        return n_bytes, steps + window * (6 + arity)
    if name == "index_join":
        lv, lm, ks, perm, targets = args[:5]
        cap = args[-1]
        pairs_used = min(int(out[2]), cap)
        steps = 2 * max(1, math.ceil(math.log2(max(ks.numel(), 2))))
        arity = targets.shape[1]
        n_bytes = (nb(lv) + nb(lm) + lv.shape[0] * steps * 8
                   + pairs_used * 4 * (1 + arity) + nb(out[0]) + nb(out[1]) + 8)
        return n_bytes, lv.shape[0] * (steps + 4) + cap * (2 * steps + 8)
    if name == "join_tables":
        lv, lm, rv, rm = args[:4]
        cap = args[-1]
        n_r = max(rv.shape[0], 2)
        n_bytes = nb(lv) + nb(lm) + nb(rv) + nb(rm) + nb(out[0]) + nb(out[1]) + 8
        ops = (lv.shape[0] + rv.shape[0]) * 8 + 8 * rv.shape[0] * 12 \
            + lv.shape[0] * 4 * math.log2(n_r) + cap * (2 * math.log2(max(lv.shape[0], 2)) + 8)
        return n_bytes, ops
    lv, lm, rv, rm = args[:4]
    n_r = max(rv.shape[0], 2)
    n_bytes = nb(lv) + nb(lm) + nb(rv) + nb(rm) + nb(out)
    ops = (lv.shape[0] + rv.shape[0]) * 8 + 8 * rv.shape[0] * 12 + lv.shape[0] * 4 * math.log2(n_r)
    return n_bytes, ops


def phase_kernels(das, gene_name, iters):
    """Every kernel against its plain version, exact.  Returns the timing
    rows of the main-path case of each kernel."""
    import torch

    from das_tpu_torch import kernels
    from das_tpu_torch.ops.join import SENTINEL_L, SENTINEL_R, mix_columns

    wrappers = {
        "probe": (kernels.probe_term_table, kernels.probe_term_table_plain),
        "index_join": (kernels.index_join, kernels.index_join_plain),
        "join_tables": (kernels.join_tables, kernels.join_tables_plain),
        "anti_join": (kernels.anti_join, kernels.anti_join_plain),
    }
    main = main_path_inputs(das, gene_name)
    missing = sorted(set(wrappers) - set(main))
    if missing:
        raise AssertionError(f"the main path gave no inputs to {missing}")

    dev = torch.device(DEVICE)
    member = das.db.dev.buckets[2]
    tid_member = das.db._type_id("Member")
    n_member = int((das.db.fin.buckets[2].type_id == tid_member).sum())
    big_cap = 1 << max(21, math.ceil(math.log2(n_member)))
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def rand_table(n, k, low, high, p_valid=0.9):
        vals = torch.randint(low, high, (n, k), generator=gen, dtype=torch.int32)
        valid = torch.rand(n, generator=gen) < p_valid
        return (torch.where(valid[:, None], vals, 0).to(dev).contiguous(), valid.to(dev))

    pargs, pkw = main["probe"]
    iargs = main["index_join"][0]
    jargs = main["join_tables"][0]
    aargs = main["anti_join"][0]
    cols = dict(var_cols=(0, 1), eq_pairs=(), extra_fixed=())
    # the V3 column of real Member rows: ~members-per-process ties per key
    procs = member.targets[: 1 << 16, 1:2].contiguous()
    ones = torch.ones(procs.shape[0], dtype=torch.bool, device=dev)
    left, lmask = rand_table(4096, 2, int(procs.min()), int(procs.max()) + 1)
    empty_v = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    empty_m = torch.zeros(0, dtype=torch.bool, device=dev)
    cases = [
        ("probe", "main path (int64 type_pos key)", pargs, pkw),
        ("probe", "whole-type window (int32 key_type)",
         (member.key_type, member.order_by_type, member.targets, tid_member, [], big_cap), cols),
        ("probe", "total > cap (int32 key_type)",
         (member.key_type, member.order_by_type, member.targets, tid_member, [], 4096), cols),
        ("index_join", "main path", iargs, {}),
        ("index_join", "total > cap",
         (*iargs[:-1], max(16, int(iargs[-1]) // 8)), {}),
        ("join_tables", "main path", jargs, {}),
        ("join_tables", "tied keys, total > cap",
         (left, lmask, procs, ones, ((1, 0),), (0,), 4096), {}),
        ("join_tables", "empty right", (*jargs[:2], empty_v[:, :1], empty_m,
                                         jargs[4], jargs[5], jargs[6]), {}),
        ("anti_join", "main path", aargs, {}),
        ("anti_join", "tied keys", (left, lmask, procs, ones, ((1, 0),)), {}),
        ("anti_join", "empty right", (*aargs[:2], empty_v[:, :aargs[2].shape[1]], empty_m,
                                       aargs[4]), {}),
    ]
    rows = []
    for name, case, args, kw in cases:
        kernel, plain = wrappers[name]
        want = plain(*args, **kw)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(want, got)
        if err != 0:
            raise AssertionError(f"{name} [{case}] differs from its plain version: {err}")
        if name in ("probe", "index_join", "join_tables"):
            total = int(got[2])
        else:
            total = int(got.sum())
        n_bytes, n_ops = work_of(name, args, kw, got)
        bound, bound_by = bytes_bound_ms(n_bytes, n_ops)
        row = {"name": name, "case": case, "max_abs_err": err, "total": total,
               "ms": cuda_ms(lambda: kernel(*args, **kw), iters),
               "plain_ms": cuda_ms(lambda: plain(*args, **kw), iters),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        if name == "anti_join":
            lv, lm, rv, rm, pairs = args
            key_l = mix_columns(lv, tuple(a for a, _ in pairs), lm, SENTINEL_L)
            key_r = mix_columns(rv, tuple(b for _, b in pairs), rm, SENTINEL_R)
            row["library_ms"] = cuda_ms(lambda: torch.isin(key_l, key_r), iters)
        if name == "probe":
            row["window"] = min(int(got[2]), args[-1])
            row["cap"] = args[-1]
        rows.append(row)
    emit({"phase": "kernels", "cases": rows})
    return {r["name"]: r for r in rows if r["case"].startswith("main path")}


# ---- phase 3 ---------------------------------------------------------------------


def pick_genes(host, gene_names, seed, n=32, n_nonempty=16):
    rng = random.Random(seed)
    name_of_row = dict(zip(host.gene_rows.tolist(), gene_names))
    nonempty = sorted(name_of_row[r] for r in host.nonempty_genes().tolist())
    picks = rng.sample(nonempty, min(n_nonempty, len(nonempty)))
    rest = [g for g in rng.sample(gene_names, n + len(picks)) if g not in picks]
    return picks + rest[: n - len(picks)]


def phase_slice(args, das, data, genes, large, small):
    import torch

    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.fused import FETCH_COUNTS

    gene_names = [data.nodes[h].name for h in genes]
    host = HostKB(data, genes)
    chosen = pick_genes(host, gene_names, args.seed)
    ldas, ldata, lgenes = large

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    compiler.reset_route_counts()
    reset_launch_counts()
    fetch0 = FETCH_COUNTS["n"]
    times = {"grounded": [], "not": []}
    answers = {"grounded": [], "not": []}
    for kind, negate in (("grounded", False), ("not", True)):
        for g in chosen:
            t0 = time.perf_counter()
            answers[kind].append(answer_rows(das, grounded_query(g, negate)))
            times[kind].append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    tri_count = compiler.count_matches(ldas.db, triangle_query())
    tri_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    routes = dict(compiler.ROUTE_COUNTS)
    fetches = FETCH_COUNTS["n"] - fetch0
    n_queries = 2 * len(chosen)
    if routes["host"] != 0 or routes["fused"] + routes["staged"] != n_queries:
        raise AssertionError(f"a slice query left the device route: {routes}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    # -- correctness -----------------------------------------------------------
    n_nonempty = 0
    for kind, negate in (("grounded", False), ("not", True)):
        for g, (matched, got) in zip(chosen, answers[kind]):
            want = host.grounded(_gene_row(das, g), negate)
            if got != want or bool(matched) != bool(want):
                raise AssertionError(f"{kind} answer for {g} differs from the numpy reference")
            if kind == "grounded" and want:
                n_nonempty += 1
    if n_nonempty < 8:
        raise AssertionError(f"only {n_nonempty} grounded answers are non-empty")

    lhost = HostKB(ldata, lgenes)
    want_tri = lhost.triangle_count()
    if tri_count != want_tri:
        raise AssertionError(f"LARGE triangle count {tri_count} != numpy {want_tri}")

    # sampled answers against the host algebra (the port's memory backend)
    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    lmem = DistributedAtomSpace(backend="memory", data=ldata)
    lnames = [ldata.nodes[h].name for h in lgenes]
    lchosen = pick_genes(lhost, lnames, args.seed, n=4, n_nonempty=2)
    host_checked = 0
    for g in lchosen:
        for negate in (False, True):
            q = grounded_query(g, negate)
            if answer_set(ldas, q) != answer_set(lmem, q):
                raise AssertionError(f"LARGE {g} (not={negate}) differs from the host algebra")
            host_checked += 1
    sdas, smem = small
    if answer_set(sdas, triangle_query()) != answer_set(smem, triangle_query()):
        raise AssertionError("SMALL triangle differs from the host algebra")
    small_tri = len(answer_set(sdas, triangle_query())[1])

    p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    emit({
        "phase": "slice", "scale": args.scale, "seed": args.seed,
        "kb_nodes": das.count_atoms()[0], "kb_links": das.count_atoms()[1],
        "member_rows": int(host.member.shape[0]),
        "queries": n_queries, "nonempty_grounded": n_nonempty,
        "p50_ms": p50, "triangle_large_count": tri_count, "triangle_large_ms": tri_ms,
        "routes": routes, "launches": launches, "host_fetches": fetches,
        "host_algebra_checked": host_checked + 1, "small_triangle_rows": small_tri,
    })
    return launches


def _gene_row(das, gene_name):
    return das.db.fin.row_of_hex[das.db.get_node_handle("Gene", gene_name)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="fraction of the FlyBase-shaped KB's counts (widths are never cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50, help="timed calls per kernel case")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    t_start = time.perf_counter()
    phase_card()

    cfg = scaled(FLYBASE, args.scale)
    t0 = time.perf_counter()
    data, genes = build_kb(cfg, args.seed)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    das = DistributedAtomSpace(backend="tensor", data=data, device=DEVICE)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    store_bytes = torch.cuda.memory_allocated() - mem0
    ldata, lgenes = build_kb(LARGE, args.seed)
    ldas = DistributedAtomSpace(backend="tensor", data=ldata, device=DEVICE)
    sdata, _ = build_kb(SMALL, args.seed)
    small = (DistributedAtomSpace(backend="tensor", data=sdata, device=DEVICE),
             DistributedAtomSpace(backend="memory", data=sdata))
    emit({"phase": "kb", "config": "FlyBase-shaped (SimplePatternMiner.ipynb cell 0)",
          "scale": args.scale, "reduced": {k: [FLYBASE[k], v] for k, v in cfg.items()
                                            if v != FLYBASE[k]},
          "nodes": das.count_atoms()[0], "links": das.count_atoms()[1],
          "build_s": build_s, "finalize_upload_s": upload_s,
          "store_bytes_allocated": store_bytes, "store_tensor_bytes": das.db.dev.nbytes()})

    host = HostKB(data, genes)
    gene_names = [data.nodes[h].name for h in genes]
    main_gene = pick_genes(host, gene_names, args.seed, n=1, n_nonempty=1)[0]
    timing = phase_kernels(das, main_gene, args.iters)
    launches = phase_slice(args, das, data, genes, (ldas, ldata, lgenes), small)

    kernels_line = []
    for name, (source, replaces) in TPU_KERNELS.items():
        t = timing[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"elapsed_s": time.perf_counter() - t_start})
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
