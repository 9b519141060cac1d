#!/usr/bin/env python3
"""Smoke run of das_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--scale S] [--seed N]
                          [--only-ingest | --only-sharded | --only-multiprocess |
                           --only-ontology | --only-programs]

Phases, one JSON line each:

  1. card    — the card's name and power limit (nvidia-smi), then the
               build of the hand-written CUDA kernels from csrc/ with their
               `-Xptxas -v` register / shared-memory / spill report;
  2. kernels — every kernel against its plain PyTorch version on the same
               CUDA tensors, exact: the main path's own inputs plus a
               whole-type probe window of >= 2^21 rows, the multiway
               calls of one grounded star and of one fan-out star whose
               Member tail has >= 2^21 rows, totals past capacity, tied
               keys, an empty side or intersection, an all-invalid left
               or right side, a star of 18 tails, int32 and int64 probe
               keys, a plan's probed terms in one call (the grounded
               query's, and the grounded and Not queries' together),
               fan-out-sized tails holding v and ~v (equal mixed keys),
               the int64 wraparound of four 2^16-row tails, a two-pair
               sort-merge join key, index joins with an all-invalid or
               empty left side, a negative join value, a second pair that
               fails on some slots and no right_extra, and a case for
               every regime of the index join (block, global: 65,536
               Member process ids), the sort-merge join (block, global),
               the anti join (shared, global) and the multiway join
               (block, filter, global), a star of 30 tails (descriptors in
               device memory), each held to the regime named for it (the
               phase fails if a regime ran no case); times from CUDA
               events, the kernels launched per call (every probe call
               and every main-path call of a kernel with regimes: 1),
               and for each such main-path call the host time of a call
               queued behind a sleep kernel (the wrapper must not wait);
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
               configuration against the host algebra.  The queries
               are planned by the cost planner (the default config);
  4. serving — the batched serving path through the public API on the same
               store: one query_many of the slice's 32 grounded and 32 Not
               queries plus 8 in-batch duplicates (every answer against
               numpy and against query(); host fetches equal to the batch's
               retry rounds; 72 fused, 0 staged, 0 host); the batch again
               from the result cache (0 launches, 0 fetches); 64 grounded
               queries on other genes in 4 groups of 16, group k+1
               dispatched before group k settles; query_many_dispatch of 16
               queries queued behind a sleep kernel with the cache off (the
               dispatch half must not wait); the 16 reseed shapes of phase
               count_batch through query_many and query_answer (fused, by
               the exact program; answers against a numpy evaluation of the
               reference fold); and on the SMALL configuration a batch
               dispatched, then a Member link loaded, then settled (the new
               link is in the answer);
  5. planned — the planner's path, from a fresh executor: 32 grounded
               stars Member($V1, p1) and Member($V1, p2) and
               Interacts(g, $V1), 8 fan-out stars Member($V1, p) and
               Member($V1, $P2) and Interacts($V1, $V2), and the 32
               grounded queries, under use_planner / use_multiway "auto":
               routes, planner counters, host fetches and p50 per family,
               multiway launches (the phase fails without one).  Every
               answer is checked against numpy, and again with the
               multiway step off (stars), the planner off (grounded) and,
               for a family auto routed none of, the multiway step on;
  6. count_batch — 256 grounded queries counted in one count_batch call
               after a warm call: per-query ms, groups, lanes after dedup,
               host fetches; every count against numpy.  Then a check
               list on the card: 64 grounded queries (48 with non-empty
               answers) and 16 reseed shapes Member(g1, $V3) and
               Member(g2, $V3) and Interacts(g3, $V2), half of whose pairs
               share no process, so the exact second pass must run; every
               count against numpy, three non-zero ones and a re-seeded
               one against count_matches;
  7. api     — explain(q) and explain(q, execute=True) of one grounded, one
               Not, one grounded-star and one fan-out-star query (planned,
               the planner's order, a multiway step for the stars, the
               executed count equal to numpy's, no retry round once the
               capacities are warm), and the read surface: get_links
               ("Member", [gene, "*"]) of 8 genes against numpy in handle
               space, get_node / get_node_name / get_node_type /
               get_link_type / get_link_targets against the records;
  8. tree    — the tree executor on the same store, 16 queries a family:
               Ors of two and of three grounded chains Member(g, $V3) and
               Member($V2, $V3) (one whole-tree job each: one host fetch a
               round), an Or with a Not branch (the de-Morgan difference),
               an Or over different variable sets and an And over an Or
               (the staged tree), the unordered Interacts template joined
               to a grounded Interacts term, and on LARGE to a grounded
               Member term (a composite join); p50 / p90 ms, answers,
               fetches, rounds, routes and launches per family; every
               answer against numpy set algebra over the host store, every
               count_matches against it, no host route.  Then two families
               again from the cache (0 launches, 0 fetches), explain of
               three shapes, a whole-tree dispatch queued behind a sleep
               kernel (it must not wait), the animals Similarity queries
               against the host algebra (the unordered device probe) and a
               query the tree planner cannot plan (count_matches None), a
               cached tree answer across a commit on SMALL, and get_links
               of 8 genes through the device probes against MemoryDB's
               host scan of the same store, both timed;
     entry — the entry points beside the package: (a) the 55-query
               regression battery (scripts/regression_torch.py) on the
               animals KB in a tensor store on the card, in the same store
               called as the reference's script calls it (the `das` shim's
               routed classes, `expr.matched(db, answer)`), and on 8 slabs,
               each equal in all 56 normalized blocks to the MemoryDB
               battery of this run and to data/samples/regression_expected.txt
               (das_tpu's output); (b) the `das` shim (compat_torch/) on
               phase kb's store: grounded, Not and fan-out-star queries
               built from its routed classes and called as
               `expr.matched(das.db, answer)`, each answer set equal to
               `query_answer`'s, no host route, probe launches rising and
               anti-join launches rising for Not, p50 ms beside the
               facade's; (c) the CLIs in-process: load_das_torch.py of a
               small canonical file (SMALL, the native scanner, built and
               timed first) into a store on the card, with --checkpoint;
               dump_das_torch.py of that checkpoint, on the host tables,
               byte-equal to convert/dump.py's dump of the generator's own
               build of SMALL; and dump_trace_torch.py of a few served
               queries: one file, the profiler's trace with the recorder's
               spans merged onto its clock (every launch inside a
               serve.dispatch starts after it), the spans' names
               obs/registry.py's;
  9. sharded — the sharded store (parallel/): phase kb's configuration
               and seed built again and dealt over 8 slabs on the card,
               DistributedAtomSpace(backend="sharded"); 16 grounded, 16
               Not, 16 grounded-star, 8 fan-out-star, 8 reseed and 8
               template-join queries (the template term is materialized,
               so its join hash-partitions) and the LARGE triangle, each
               answer against numpy and the tensor store's, the p50 per
               family beside the tensor store's in this run; the index,
               broadcast-right and hash-partitioned joins the plans ran
               (the phase fails if one kind never ran, or a kernel never
               launched); one query_many of the grounded and Not queries
               and the same batch from the cache (0 launches, 0 fetches);
               the or2, or_not (the whole-tree mesh job), and_or and
               unordered tree families against numpy and the animals
               Similarity links against the host algebra; one commit of
               256 genes (incremental; every slab-local index sorted and
               consistent; the slabs equal to a re-partition of the
               committed records in handle space; the new genes' answers
               against numpy); on SMALL a snapshot and restore with every
               slab bit-equal.  With --only-sharded, phases card, kb and
               sharded run alone (no kernels line);
 10. multiprocess — the mesh across processes: two child processes of
               this script (gloo on 127.0.0.1, 2 slabs each on cuda:0, S =
               4) each build phase kb's configuration from the same seed
               and upload only their own slabs; 16 grounded and Not, 8
               grounded-star, 4 fan-out-star and 4 template-join count-only
               queries (the template joins hash-partition, so all_to_all
               crosses the processes), every count equal to numpy's and
               the tensor store's, both ranks' stats vectors equal, all
               five kernels launched in each child; partition, upload and
               p50 beside phase sharded's, and each collective's calls,
               wall and host-staging share.  A child that fails or runs
               past 600 s fails the phase (--only-multiprocess: card, kb
               and this phase);
 11. ontology — the reference benchmark's three query layouts on
               build_bio_ontology_atomspace at a tenth of phase kb's gene,
               process and interaction counts (Reactomes and Uniprots
               scaled from their defaults by the same factor; the cut keeps
               the smoke inside its limit): QUERY_1 and QUERY_2 with 2
               genes, 100 rounds each, and QUERY_3 (3 rounds), on
               the tensor store and an 8-slab sharded store; p50, matched
               counts, routes and launches; sampled answers against the
               host algebra (--only-ontology: card and this phase);
 12. programs — the program ledger on (obs/proflog.py): the cold start
               (the kernel library's nvcc build and the scanner's g++ build
               into empty directories, then loads of them), the slice's and
               the tree's families, a count group and an 8-slab LARGE store
               cold then warm, the ledger's snapshot and each modeled
               site's budget_vs_actual on the card; then a torch.profiler
               Chrome trace (DasConfig.profiler_trace_dir) that must hold
               exec.dispatch and the five kernels (--only-programs: card,
               kb and this phase);
 13. commit  — after the reads, since it changes the store: three
               transactions of 256 new genes (4 Member links into existing
               processes and 2 Interacts links with an existing gene each,
               1,792 atoms)
               and one of 512 links among existing atoms, through
               open_transaction / commit_transaction.  Each commit must be
               incremental (_delta_total up by its atoms, delta_version up
               by 1, the arity-2 capacity and the store's bytes unchanged);
               wall ms per commit and the device merge's ms by CUDA events.
               After each, 32 grounded and 32 Not queries on new and touched
               genes and a grounded star (multiway) against numpy: the
               pre-commit HostKB plus the pairs the phase wrote, in handle
               space.  The serving batch across the first commit (one
               invalidation, no hits, the new answers), a batch dispatched
               before the fourth commit and settled after it, the merged
               posting columns' structure, one merge again on CPU copies
               (bit-equal); a whole-tree and a staged tree answer cached
               before the first commit answer anew after it, and get_links
               of 8 new or touched genes equals the host scan; on SMALL,
               commits until the arity-2 bucket
               grows, a new 3-ary link type and a commit past a small
               delta_merge_threshold (a rebuild), each against the host
               algebra;
 14. miner   — after the commits, on the committed store with its overlay
               segments: bench.py's miner, PatternMiner(halo_length=2,
               link_rate=0.01, seed=7) on the first 3 genes, expand_halo,
               build_patterns and mine(ngram=3, epochs=100); halo links,
               candidates, halo / counting / joints s, ms per halo link,
               the joints' routes, host fetches and launches; every
               candidate's count against numpy over the host link columns
               (no index, no probe).  The drawn composites with a grounded
               term (at least 32, at least 32 of them non-zero) and the
               2-term sub-joints the miner counted for their scores, each
               counted by the host star fold, the device fold and
               count_batch (the probe and join kernels; whole-table x
               whole-table joints left out), all equal; the animals KB's
               miner on the card equal to the memory backend's, its
               unordered candidates through the tree executor's kernels;
 15. service — on the committed store, attached to a DasService tenant
               (attach_tenant) and driven through its request dicts, the
               methods the gRPC servicer adapts (the card machine has no
               grpc): 8 client threads x 32 DSL queries (96 grounded, 96
               Not, 48 grounded stars on genes no earlier phase drew, 16
               exact duplicates) through the tenant's coalescer, every
               answer equal to serial query()'s, fewer batches than items,
               >= 2 groups in flight; queries/s, RPC p50 / p99, fetches per
               query, launches, effective_depth and both EWMAs.  The same
               traffic traced (spans per name, a Chrome trace written and
               parsed back, the serving gauges of metrics_text, the
               worker's span times against the pass's wall), two more
               pairs of untraced and traced passes (p50 and queries/s of
               each, the spread) and under a seeded fault plan over
               settle_fetch, cache_insert, dispatch_enqueue,
               worker_iteration and submit_queue (every site fired,
               fault.retries > 0, the same answers but typed submit_queue
               statuses).  Group k's settle returns while a sleep kernel
               queued before group k+1 runs (both times printed); a
               terminal settle failure trips a tenant's breaker (a cached
               query answers with 0 launches, an uncached one is a
               breaker_open status, the probe after the cooldown restores
               service: trips 1, recoveries 1); a queued query behind a
               sleep kernel comes back as a typed deadline status; one
               commit with commit_apply injected once lands on retry while
               queries are in flight, its link in the answers after it;
 16. durable — last, since it ends the store: the free disk of a new
               temporary root, then save_snapshot of the committed store
               (wall s, each part's s, each section's bytes), two commits
               of 1,792 atoms with the write-ahead log armed (wall ms beside
               phase commit's unarmed p50, the WAL's bytes; each commit
               split into a timed gc.collect() before it, the parse into
               the host store, the add that frees the host Finalized the
               snapshot cached, the WAL append and the collector's pauses
               inside it), the store
               dropped and DistributedAtomSpace(backend="tensor",
               config=DasConfig(snapshot_dir=root)) restoring it (wall s
               and its parts beside phase kb's build_s +
               finalize_upload_s; 2 records replayed; the dead store's
               delta_version and _delta_total), and on the restored store
               phase slice's grounded and Not queries, phase planned's
               grounded stars and phase tree's or2 family, answers against
               the dead store's and numpy's (CommitRef), launches per
               kernel.  On SMALL: attach at construction, two commits, the
               store dropped and restored with every table bit-equal to
               the dead store's; half a frame appended to the WAL (cut,
               never replayed); a newer generation with a damaged records
               section (the restore falls back to the prior one and its
               WAL, bit-equal again); and with the planner off, the warm
               bundle applied at its version (first-pass rounds with it,
               without it, and after a commit past it, when it is
               discarded).  The root is removed at the end;
 17. ingest  — after durable (the main store is gone): the same FlyBase-
               shaped configuration and seed written as a canonical file
               (`write_bio_canonical`) into a temporary directory, loaded
               by `load_canonical_knowledge_base` into a fresh store on the
               card through the native scanner's columnar route; the
               generation, the scan into columns and finalize plus upload
               timed apart, with MB/s, expressions/s, the process's RSS
               (sampled) and the store's bytes; the handle sets, every
               Finalized array and every device tensor held bit for bit
               against the in-process build (its record prefix, finalized
               by the dict path); phase durable's families (4 Ors) against
               numpy, a 256-gene commit onto the columnar store
               (incremental), the families and the new genes' queries
               again; and the animals KB dumped by `write_canonical` and
               loaded through the columnar route, its tree queries equal
               to `load_knowledge_base` of the .metta file.  With
               --only-ingest, phases card and ingest run alone (no
               kernels line): the full-scale ingest measurement.

Then a line {"kernels": [...]} with each kernel's route, source, the TPU
kernel it replaces, launches on the main path (every phase's after phase
kernels, count_batch and miner included), error against the plain
version, its time, the plain version's, the bound and a library call's
time where one PyTorch call computes the same function; and last
{"ok": true, "device": {...}}.  Any mismatch raises: the exit code is then
non-zero and no result line is printed.  Without a CUDA card, or without
the das_tpu_torch package beside it, the script exits non-zero."""

from __future__ import annotations

import argparse
import ast
import json
import math
import os
import random
import re
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
    "multiway": ("das_tpu_torch/kernels/csrc/multiway.cu", "das_tpu/kernels/multiway.py:190"),
}

#: recorded call -> wrapper attribute of das_tpu_torch.kernels (the executor
#: probes a plan's terms in one probe_term_tables call)
WRAPPERS = {
    "probe_terms": "probe_term_tables", "index_join": "index_join",
    "join_tables": "join_tables", "anti_join": "anti_join", "multiway": "multiway_join",
}


def regime_counts():
    """launch.REGIME_COUNTS as {"kernel/regime": calls}."""
    from das_tpu_torch.kernels import launch

    return {f"{k}/{r}": n for (k, r), n in launch.REGIME_COUNTS.items()}


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


def queued_host_ms(fn, cycles: int = 100_000_000):
    """(host ms of fn(), ms until the card is done) with fn queued behind a
    sleep kernel of `cycles` cycles: the first is far below the second when
    fn only enqueues work and never waits on the stream."""
    import torch

    fn()
    torch.cuda._sleep(1000)       # the sleep kernel's own first launch is slow
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host, (time.perf_counter() - t0) * 1e3


def flat(out):
    """The output tensors of a call as one tuple (a multi-term probe returns
    a list of per-term tuples)."""
    if isinstance(out, list):
        return tuple(t for term in out for t in term)
    return out if isinstance(out, tuple) else (out,)


def max_abs_err(want, got) -> int:
    """Largest absolute difference over every output of a call (0 = exact)."""
    import torch

    want, got = flat(want), flat(got)
    if len(want) != len(got):
        raise AssertionError(f"{len(got)} outputs, expected {len(want)}")
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

    def grounded_star(self, g, p1, p2):
        """{(V1,)} of the grounded star."""
        both = set(self.members(p1).tolist()) & set(self.members(p2).tolist())
        return {(v,) for v in set(self.partners(g).tolist()) & both}

    def fanout_star(self, p):
        """{(V1, P2, V2)} of the fan-out star."""
        return {(v1, p2, v2) for v1 in set(self.members(p).tolist())
                for p2 in self.procs(v1).tolist() for v2 in self.partners(v1).tolist()}

    def reseed_count(self, g1, g2, g3):
        """|answer| of And(Member(g1, V3), Member(g2, V3), Interacts(g3, V2))
        under the reference fold: a positive term with no rows empties the
        answer; a first join with no shared process empties the accumulator,
        and the Interacts term then re-seeds it."""
        shared = set(self.procs(g1).tolist()) & set(self.procs(g2).tolist())
        n3 = len(self.partners(g3))
        if not len(self.procs(g1)) or not len(self.procs(g2)):
            return 0
        return max(len(shared), 1) * n3

    def reseed_answer(self, g1, g2, g3):
        """The answer of the same query under the reference fold, as
        {frozenset((variable, row))}: (V3, V2) pairs when g1 and g2 share a
        process, else the re-seeded Interacts term's V2 alone."""
        if not len(self.procs(g1)) or not len(self.procs(g2)):
            return set()
        shared = set(self.procs(g1).tolist()) & set(self.procs(g2).tolist())
        partners = set(self.partners(g3).tolist())
        if shared:
            return {frozenset({("V3", p), ("V2", v)}) for p in shared for v in partners}
        return {frozenset({("V2", v)}) for v in partners}

    def reseed_triples(self, seed, n):
        """n (g1, g2, g3) gene rows: half the pairs share a process, half
        share none; g3 always has an interaction partner."""
        rng = random.Random(seed)
        with_procs = sorted(set(self.member[:, 0].tolist()))
        partnered = sorted(set(self.interacts[:, 0].tolist()))
        out = []
        while len(out) < n:
            g1 = rng.choice(with_procs)
            procs = self.procs(g1).tolist()
            if len(out) % 2 == 0:
                g2 = rng.choice(self.members(rng.choice(procs)).tolist())
            else:
                g2 = rng.choice(with_procs)
                if set(procs) & set(self.procs(g2).tolist()):
                    continue
            if g2 != g1:
                out.append((g1, g2, rng.choice(partnered)))
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


def grounded_star_query(gene_name, p1, p2):
    """Member($V1, p1) and Member($V1, p2) and Interacts(g, $V1)."""
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    return And([
        Link("Member", [Variable("V1"), Node("BiologicalProcess", p1)], True),
        Link("Member", [Variable("V1"), Node("BiologicalProcess", p2)], True),
        Link("Interacts", [Node("Gene", gene_name), Variable("V1")], True),
    ])


def reseed_query(g1, g2, g3):
    """Member(g1, $V3) and Member(g2, $V3) and Interacts(g3, $V2): when g1
    and g2 share no process the reference fold re-seeds on the last term."""
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    return And([
        Link("Member", [Node("Gene", g1), Variable("V3")], True),
        Link("Member", [Node("Gene", g2), Variable("V3")], True),
        Link("Interacts", [Node("Gene", g3), Variable("V2")], True),
    ])


def fanout_star_query(p):
    """Member($V1, p) and Member($V1, $P2) and Interacts($V1, $V2): its
    tails are the whole Member and Interacts types."""
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    return And([
        Link("Member", [Variable("V1"), Node("BiologicalProcess", p)], True),
        Link("Member", [Variable("V1"), Variable("P2")], True),
        Link("Interacts", [Variable("V1"), Variable("V2")], True),
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


def answer_tuples(das, query, names):
    """(matched, {tuple of the rows bound to `names`})."""
    matched, answer = das.query_answer(query)
    row = das.db.fin.row_of_hex
    return bool(matched), {tuple(row[a.mapping[n]] for n in names) for a in answer.assignments}


def answer_set(das, query):
    matched, answer = das.query_answer(query)
    return bool(matched), {frozenset(a.mapping.items()) for a in answer.assignments}


# ---- phase 2 ---------------------------------------------------------------------


def bytes_bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_inputs(run):
    """Call `run()` with every kernel wrapper recording the arguments of
    its first call: the exact inputs the executor gives each kernel."""
    from das_tpu_torch import kernels

    calls, saved = {}, {}
    for name, attr in WRAPPERS.items():
        saved[attr] = fn = getattr(kernels, attr)

        def rec(*a, _name=name, _fn=fn, **kw):
            calls.setdefault(_name, (a, kw))
            return _fn(*a, **kw)

        setattr(kernels, attr, rec)
    try:
        run()
    finally:
        for attr, fn in saved.items():
            setattr(kernels, attr, fn)
    return calls


def main_path_inputs(das, gene_name, star, fanout):
    """The kernel calls of one grounded query and its Not variant, and the
    multiway calls of one grounded star and one fan-out star, at the
    capacities their executions settled on (each query runs once first).
    "probe_terms_not" is the Not variant's probe call."""
    calls = {}
    for q in (grounded_query(gene_name), grounded_query(gene_name, True)):
        das.query_answer(q)
        for name, call in record_inputs(lambda: das.query_answer(q)).items():
            if name == "probe_terms" and name in calls:
                calls["probe_terms_not"] = call
            calls.setdefault(name, call)
    cfg = das.db.config
    mode, cfg.use_multiway = cfg.use_multiway, "on"   # the multiway route, whatever auto says
    try:
        for key, q in (("multiway", star), ("multiway_whole_type", fanout)):
            das.query_answer(q)
            calls[key] = record_inputs(lambda: das.query_answer(q))["multiway"]
    finally:
        cfg.use_multiway = mode
    return calls


def work_of(name, args, kw, out):
    """(bytes, operations) the call's data needs: every input it must read
    once, every output written once; a probe or index join reads only the
    posting-index window its keys select; a multiway join reads every
    mask, the v column of the valid rows, and the other columns only of
    the rows it emits."""

    def nb(t):
        return t.numel() * t.element_size()

    if name == "probe" and isinstance(out, list):
        works = [work_of("probe", tuple(t[:6]), {}, o) for t, o in zip(args[0], out)]
        return sum(w[0] for w in works), sum(w[1] for w in works)
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
    if name == "multiway":
        lv, lm, tails, _vcol0, meta, cap = args
        n_l = int(lm.sum())
        n_out = int(out[1].sum())
        n_valid = [int(m.sum()) for _v, m in tails]
        n_bytes = nb(lm) + n_l * 4 + n_out * 4 * (lv.shape[1] - 1) \
            + sum(nb(m) + n * 4 + n_out * 4 * len(extra)
                  for (_v, m), n, (_c, extra) in zip(tails, n_valid, meta)) \
            + nb(out[0]) + nb(out[1]) + nb(out[2])
        ops = n_l * 8 + sum(
            n * (8 + 8 * 12) + n_l * 4 * math.log2(max(n, 2)) for n in n_valid
        ) + min(int(out[2][-1]), cap) * (2 * math.log2(max(n_l, 2)) + 8 * len(tails))
        return n_bytes, ops
    lv, lm, rv, rm = args[:4]
    n_r = max(rv.shape[0], 2)
    n_bytes = nb(lv) + nb(lm) + nb(rv) + nb(rm) + nb(out)
    ops = (lv.shape[0] + rv.shape[0]) * 8 + 8 * rv.shape[0] * 12 + lv.shape[0] * 4 * math.log2(n_r)
    return n_bytes, ops


def phase_kernels(das, gene_name, star, fanout, iters):
    """Every kernel against its plain version, exact.  Returns the timing
    rows of the main-path case of each kernel (for the multiway kernel the
    grounded star's, the planned phase's main case)."""
    import torch

    from das_tpu_torch import kernels
    from das_tpu_torch.kernels import launch
    from das_tpu_torch.ops.join import SENTINEL_L, SENTINEL_R, mix_columns

    wrappers = {
        "probe": (kernels.probe_term_table, kernels.probe_term_table_plain),
        "probe_terms": (kernels.probe_term_tables, kernels.probe_term_tables_plain),
        "index_join": (kernels.index_join, kernels.index_join_plain),
        "join_tables": (kernels.join_tables, kernels.join_tables_plain),
        "anti_join": (kernels.anti_join, kernels.anti_join_plain),
        "multiway": (kernels.multiway_join, kernels.multiway_join_plain),
    }
    main = main_path_inputs(das, gene_name, star, fanout)
    missing = sorted(set(wrappers) - {"probe"} - set(main))
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

    terms = main["probe_terms"][0][0]
    both_terms = list(terms) + list(main["probe_terms_not"][0][0])
    t0 = terms[0]
    one_term = (tuple(t0[:6]), dict(var_cols=t0.var_cols, eq_pairs=t0.eq_pairs,
                                    extra_fixed=t0.extra_fixed))
    iargs = main["index_join"][0]
    jargs = main["join_tables"][0]
    aargs = main["anti_join"][0]
    margs = main["multiway"][0]
    wargs = main["multiway_whole_type"][0]
    if wargs[2][0][0].shape[0] < n_member:
        raise AssertionError("the fan-out star's Member tail is not the whole Member type")
    cols = dict(var_cols=(0, 1), eq_pairs=(), extra_fixed=())
    # the V3 column of real Member rows: ~members-per-process ties per key
    procs = member.targets[: 1 << 16, 1:2].contiguous()
    ones = torch.ones(procs.shape[0], dtype=torch.bool, device=dev)
    left, lmask = rand_table(4096, 2, int(procs.min()), int(procs.max()) + 1)
    empty_v = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    empty_m = torch.zeros(0, dtype=torch.bool, device=dev)
    # the fan-out star's tails with every other v replaced by ~v: mix(~v) ==
    # mix(v), so those rows pass the filter, count in the totals and fail
    # the exact check
    flipped = []
    for (tv, tm), (vcol, _extra) in zip(wargs[2], wargs[4]):
        tv = tv.clone()
        tv[1::2, vcol] = ~tv[1::2, vcol]
        flipped.append((tv, tm))
    # a left side whose set (2^15 slots) outgrows a count block's shared memory
    big_left, big_lmask = rand_table(9000, 2, int(procs.min()), int(procs.max()) + 1)
    wrap = torch.zeros((1 << 16, 1), dtype=torch.int32, device=dev)
    wrap_m = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    r_big, r_big_m = rand_table(20000, 1, int(procs.min()), int(procs.max()) + 1)
    # a two-pair key: Member rows (gene, process) against a left side that
    # holds some of them, others with one column changed
    pairs_r = member.targets[: 1 << 11].contiguous()
    pairs_l = pairs_r[torch.randperm(pairs_r.shape[0], generator=gen)[:1500].to(dev)].clone()
    pairs_l[::3, 1] += 1
    pairs_lm = torch.ones(pairs_l.shape[0], dtype=torch.bool, device=dev)
    # index joins into the main path's posting index: real Member rows
    # (gene, process) keyed on the process, so a second pair on the gene
    # passes on one slot of each window; 65,536 process ids for `global`
    fin_b = das.db.fin.buckets[2]
    mem_rows = torch.from_numpy(fin_b.targets[fin_b.type_id == tid_member][: 1 << 16]).to(dev)
    ipairs, icols = iargs[6], iargs[7]
    rc_key = ipairs[0][1]
    rc_other = next(rc for rc in range(len(icols)) if rc != rc_key)
    ilv, ilm = iargs[0].clone(), iargs[1].clone()
    ilv[0, ipairs[0][0]] = -ilv[0, ipairs[0][0]] - 1      # sign-extended: finds nothing
    ilm[0] = True
    mem_ones = torch.ones(mem_rows.shape[0], dtype=torch.bool, device=dev)
    member_left = mem_rows[torch.randperm(mem_rows.shape[0], generator=gen)[:16].to(dev)]
    member_left = member_left.contiguous()
    index = iargs[2:6]
    # (wrapper, case, args, kwargs, the regime the wrapper must take); the
    # kernel is the wrapper's name, "probe" for both probe wrappers
    cases = [
        ("probe_terms", f"main path (the grounded query's {len(terms)} probed terms, one call)",
         (terms,), {}, "warp_search"),
        ("probe_terms", f"multi-term call (the grounded and Not queries' {len(both_terms)} "
         "probed terms)", (both_terms,), {}, "warp_search"),
        ("probe", f"one term ({t0.sorted_keys.dtype} key)", *one_term, "warp_search"),
        ("probe", "whole-type window (int32 key_type)",
         (member.key_type, member.order_by_type, member.targets, tid_member, [], big_cap), cols,
         "warp_search"),
        ("probe", "total > cap (int32 key_type)",
         (member.key_type, member.order_by_type, member.targets, tid_member, [], 4096), cols,
         "warp_search"),
        ("index_join", "main path", iargs, {}, "block"),
        ("index_join", "total > cap",
         (*iargs[:-1], max(16, int(iargs[-1]) // 8)), {}, "block"),
        ("index_join", "all-invalid left",
         (iargs[0], torch.zeros_like(iargs[1]), *iargs[2:]), {}, "block"),
        ("index_join", "empty left", (iargs[0][:0], iargs[1][:0], *iargs[2:]), {}, "block"),
        ("index_join", "second pair failing on some slots (16 Member rows)",
         (member_left, mem_ones[:16], *index, ((1, rc_key), (0, rc_other)), icols,
          (rc_other,), 4096), {}, "block"),
        ("index_join", "no right_extra", (*iargs[:8], (), iargs[9]), {}, "block"),
        ("index_join", "negative join value", (ilv, ilm, *iargs[2:]), {}, "block"),
        ("index_join", "global: 65,536 Member process ids, total > cap",
         (mem_rows[:, 1:2].contiguous(), mem_ones, *index, ((0, rc_key),), icols,
          (rc_other,), 1 << 16), {}, "global"),
        ("join_tables", "main path", jargs, {}, "block"),
        ("join_tables", "tied keys, total > cap (right: 65,536 procs rows)",
         (left, lmask, procs, ones, ((1, 0),), (0,), 4096), {}, "global"),
        ("join_tables", "empty right", (*jargs[:2], empty_v[:, :1], empty_m,
                                         jargs[4], jargs[5], jargs[6]), {}, "block"),
        ("join_tables", "two-pair key",
         (pairs_l, pairs_lm, pairs_r, ones[: pairs_r.shape[0]], ((0, 0), (1, 1)), (), 4096),
         {}, "block"),
        ("join_tables", "all-invalid left",
         (jargs[0], torch.zeros_like(jargs[1]), *jargs[2:]), {}, "block"),
        ("anti_join", "main path", aargs, {}, "shared"),
        ("anti_join", "tied keys", (left, lmask, procs, ones, ((1, 0),)), {}, "global"),
        ("anti_join", "empty right", (*aargs[:2], empty_v[:, :aargs[2].shape[1]], empty_m,
                                       aargs[4]), {}, "shared"),
        ("anti_join", "all-invalid right, valid left",
         (*aargs[:2], aargs[2], torch.zeros_like(aargs[3]), aargs[4]), {}, "shared"),
        ("anti_join", "global set (right 20,000 rows)",
         (left, lmask, r_big, r_big_m, ((1, 0),)), {}, "global"),
        ("multiway", "main path (grounded star)", margs, {}, "block"),
        ("multiway", "whole-type fan-out star", wargs, {}, "filter"),
        ("multiway", "fan-out star, tails with v and ~v", (*wargs[:2], flipped, *wargs[3:]),
         {}, "filter"),
        ("multiway", "tied keys, total > cap, survivors in 9 blocks",
         (left, lmask, [(procs, ones), (procs[:4096], ones[:4096])], 1,
          ((0, ()), (0, ())), 1024), {}, "filter"),
        ("multiway", "empty intersection",
         (left, lmask, [(procs + (1 << 30), ones)], 1, ((0, ()),), 4096), {}, "filter"),
        ("multiway", "all-invalid left",
         (left, torch.zeros_like(lmask), [(procs, ones)], 1, ((0, ()),), 4096), {}, "filter"),
        ("multiway", "18 tails in one launch",
         (left[:512], lmask[:512], [(procs[:512], ones[:512])] * 18, 1, ((0, ()),) * 18,
          1024), {}, "filter"),
        ("multiway", "wraparound: four 2^16-row tails on one key",
         (wrap[:1], wrap_m[:1], [(wrap, wrap_m)] * 4, 0, ((0, ()),) * 4, 16), {}, "filter"),
        ("multiway", "30 tails, descriptors in device memory",
         (left[:512], lmask[:512], [(procs[:512], ones[:512])] * 30, 1, ((0, ()),) * 30,
          1024), {}, "filter"),
        ("multiway", "global regime (left 9,000 rows)",
         (big_left, big_lmask, [(procs, ones), (procs[:4096], ones[:4096])], 1,
          ((0, ()), (0, ())), 4096), {}, "global"),
    ]
    rows = []
    launch.reset_launch_counts()
    for wrapper, case, args, kw, regime in cases:
        kernel, plain = wrappers[wrapper]
        name = "probe" if wrapper.startswith("probe") else wrapper
        want = plain(*args, **kw)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        if regime is not None and launch.LAST_REGIME[name] != regime:
            raise AssertionError(f"{name} [{case}] took regime {launch.LAST_REGIME[name]}, "
                                 f"not {regime}")
        device_launches = launch.DEVICE_LAUNCHES[name] if regime else None
        err = max_abs_err(want, got)
        if err != 0:
            raise AssertionError(f"{name} [{case}] differs from its plain version: {err}")
        if name == "multiway":
            total = int(got[2][-1])
            if case.startswith("tied") and total <= args[-1]:
                raise AssertionError(f"multiway [{case}]: total {total} is not past capacity")
        elif wrapper == "probe_terms":
            total = sum(int(g[2]) for g in got)
        elif name in ("probe", "index_join", "join_tables"):
            total = int(got[2])
            if "total > cap" in case and total <= args[-1]:
                raise AssertionError(f"{name} [{case}]: total {total} is not past capacity")
        else:
            total = int(got.sum())
        n_bytes, n_ops = work_of(name, args, kw, got)
        bound, bound_by = bytes_bound_ms(n_bytes, n_ops)
        row = {"name": name, "case": case, "regime": regime,
               "device_launches": device_launches, "max_abs_err": err, "total": total,
               "ms": cuda_ms(lambda: kernel(*args, **kw), iters),
               "plain_ms": cuda_ms(lambda: plain(*args, **kw), iters),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        if name == "probe" and device_launches != 1:
            raise AssertionError(f"probe [{case}]: {device_launches} CUDA launches a call")
        if regime is not None and case.startswith("main path"):
            if device_launches != 1:
                raise AssertionError(f"{name} [{case}]: {device_launches} CUDA launches a call")
            row["queued_host_ms"], row["queued_card_ms"] = \
                queued_host_ms(lambda: kernel(*args, **kw))
            if row["queued_host_ms"] * 10 > row["queued_card_ms"]:
                raise AssertionError(f"{name} [{case}]: the wrapper waited on the card")
        if name == "anti_join":
            lv, lm, rv, rm, pairs = args
            key_l = mix_columns(lv, tuple(a for a, _ in pairs), lm, SENTINEL_L)
            key_r = mix_columns(rv, tuple(b for _, b in pairs), rm, SENTINEL_R)
            row["library_ms"] = cuda_ms(lambda: torch.isin(key_l, key_r), iters)
        if wrapper == "probe_terms":
            row["terms"] = len(args[0])
            row["window"] = [min(int(g[2]), t.capacity) for t, g in zip(args[0], got)]
            row["cap"] = [t.capacity for t in args[0]]
        elif name == "probe":
            row["window"] = min(int(got[2]), args[-1])
            row["cap"] = args[-1]
        if name == "join_tables":
            row["left_rows"], row["right_rows"] = args[0].shape[0], args[2].shape[0]
            row["cap"] = args[-1]
        if name == "index_join":
            row["left_rows"], row["cap"] = args[0].shape[0], args[-1]
            row["valid"] = int(got[1].sum())
            if "failing" in case and not 0 < row["valid"] < total:
                raise AssertionError(f"index_join [{case}]: no slot failed the second pair")
        if name == "multiway":
            row["left_rows"] = args[0].shape[0]
            row["tail_rows"] = [v.shape[0] for v, _m in args[2]]
            row["cap"] = args[-1]
        rows.append(row)
    idle = [f"{k}/{r}" for (k, r), n in launch.REGIME_COUNTS.items() if n == 0]
    if idle:
        raise AssertionError(f"regimes that ran no case: {idle}")
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
    regimes = regime_counts()
    routes = dict(compiler.ROUTE_COUNTS)
    fetches = FETCH_COUNTS["n"] - fetch0
    n_queries = 2 * len(chosen)
    if routes["host"] != 0 or routes["fused"] + routes["staged"] != n_queries:
        raise AssertionError(f"a slice query left the device route: {routes}")
    idle = [k for k in ("probe", "index_join", "join_tables", "anti_join") if launches[k] == 0]
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
        "routes": routes, "launches": launches, "regimes": regimes, "host_fetches": fetches,
        "host_algebra_checked": host_checked + 1, "small_triangle_rows": small_tri,
    })
    return launches, p50


def _gene_row(das, gene_name):
    return das.db.fin.row_of_hex[das.db.get_node_handle("Gene", gene_name)]


def _p50(times):
    return sorted(times)[len(times) // 2]


# ---- phase 4 ---------------------------------------------------------------------


def parse_answer(das, s):
    """{frozenset((variable, row))} of an answer string of query() or
    query_many(): each assignment prints as its variable -> handle dict."""
    row = das.db.fin.row_of_hex
    return {frozenset((k, row[h]) for k, h in ast.literal_eval(d).items())
            for d in re.findall(r"\{[^{}]*\}", s)}


def grounded_answer(host, das, gene_name, negate):
    """The numpy answer of grounded_query as {frozenset((variable, row))}."""
    return {frozenset({("V2", v2), ("V3", p)})
            for v2, p in host.grounded(_gene_row(das, gene_name), negate)}


class DispatchRounds:
    """While active, records each fused job's latest round at its dispatch
    (`rounds[job]`): a batch's retry rounds are the largest of its jobs'."""

    def __enter__(self):
        from das_tpu_torch.query import fused

        self.rounds = {}
        self._dispatch = fn = fused._ExecJob.dispatch

        def dispatch(job):
            out = fn(job)
            self.rounds[job] = job.rounds
            return out

        fused._ExecJob.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from das_tpu_torch.query import fused

        fused._ExecJob.dispatch = self._dispatch
        return False


class ExactCalls:
    """While active, counts FusedExecutor.execute_exact calls."""

    def __enter__(self):
        from das_tpu_torch.query.fused import FusedExecutor

        self.n = 0
        self._fn = fn = FusedExecutor.execute_exact

        def execute_exact(ex, *a, **kw):
            self.n += 1
            return fn(ex, *a, **kw)

        FusedExecutor.execute_exact = execute_exact
        return self

    def __exit__(self, *exc):
        from das_tpu_torch.query.fused import FusedExecutor

        FusedExecutor.execute_exact = self._fn
        return False


def other_genes(host, gene_names, used, seed, n=64, n_nonempty=32):
    """n gene names outside `used`, n_nonempty of them with non-empty
    grounded answers."""
    rng = random.Random(seed)
    name_of_row = dict(zip(host.gene_rows.tolist(), gene_names))
    nonempty = sorted(name_of_row[r] for r in host.nonempty_genes().tolist()
                      if name_of_row[r] not in used)
    picks = rng.sample(nonempty, n_nonempty)
    rest = sorted(set(gene_names) - set(used) - set(picks))
    return picks + rng.sample(rest, n - n_nonempty)


def phase_serving(args, das, data, genes, host, smi, slice_p50):
    """The batched serving path (query_many, query_many_dispatch and the
    result cache) through the public API on the slice's store.  Counters
    zeroed just before each part, read just after."""
    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.fused import FETCH_COUNTS, result_cache_stats

    gene_names = [data.nodes[h].name for h in genes]
    chosen = pick_genes(host, gene_names, args.seed)
    batch = [grounded_query(g) for g in chosen] + [grounded_query(g, True) for g in chosen]
    want = [grounded_answer(host, das, g, neg) for neg in (False, True) for g in chosen]
    dup = list(range(4)) + list(range(32, 36))
    batch += [batch[i] for i in dup]
    want += [want[i] for i in dup]

    def delta(before, after):
        return {k: after[k] - before[k] for k in before}

    # -- the batch: counters zeroed just before, read just after ---------------
    torch.cuda.synchronize()
    compiler.reset_route_counts()
    reset_launch_counts()
    f0, c0 = FETCH_COUNTS["n"], result_cache_stats(das.db)
    with DispatchRounds() as dr:
        t0 = time.perf_counter()
        answers = das.query_many(batch)
        batch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    routes = dict(compiler.ROUTE_COUNTS)
    fetches = FETCH_COUNTS["n"] - f0
    cache_first = delta(c0, result_cache_stats(das.db))
    rounds = max(dr.rounds.values())
    if fetches != rounds:
        raise AssertionError(f"serving batch: {fetches} host fetches for {rounds} retry rounds")
    if routes["fused"] != len(batch) or routes["staged"] or routes["host"]:
        raise AssertionError(f"serving batch left the fused route: {routes}")
    idle = [k for k in ("probe", "index_join", "join_tables", "anti_join") if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the serving path: {idle}")
    for i, (s, w) in enumerate(zip(answers, want)):
        if parse_answer(das, s) != w:
            raise AssertionError(f"serving batch entry {i} differs from the numpy reference")
    if answers != [das.query(q) for q in batch]:
        raise AssertionError("serving batch strings differ from query()'s")

    # -- the same batch from the result cache ----------------------------------
    reset_launch_counts()
    f0, c0 = FETCH_COUNTS["n"], result_cache_stats(das.db)
    t0 = time.perf_counter()
    again = das.query_many(batch)
    cached_ms = (time.perf_counter() - t0) * 1e3
    cached_launches = sum(LAUNCH_COUNTS.values())
    cache_repeat = delta(c0, result_cache_stats(das.db))
    if again != answers or cached_launches or FETCH_COUNTS["n"] != f0:
        raise AssertionError(f"cached batch: {cached_launches} launches, "
                             f"{FETCH_COUNTS['n'] - f0} fetches, equal={again == answers}")
    # a duplicate of a hit looks the cache up itself (the in-batch dedup
    # keys only dispatched jobs), so every one of the 72 entries hits
    if cache_repeat["hits"] != len(batch) or cache_repeat["misses"]:
        raise AssertionError(f"cached batch: cache statistics moved by {cache_repeat}")

    # -- pipelined: group k+1 dispatched before group k settles ----------------
    fresh = other_genes(host, gene_names, set(chosen), args.seed + 5)
    groups = [fresh[16 * k:16 * (k + 1)] for k in range(4)]
    reset_launch_counts()
    f0 = FETCH_COUNTS["n"]
    pend, settled = [], []
    with DispatchRounds() as dr:
        t0 = time.perf_counter()

        def dispatch(k):
            job = das.query_many_dispatch([grounded_query(g) for g in groups[k]])
            pend.append((job, [j for _i, j, _k in job.pending.jobs]))

        dispatch(0)
        for k in range(4):
            if k + 1 < len(groups):
                dispatch(k + 1)
            settled.append(pend[k][0].settle())
        pipe_ms = (time.perf_counter() - t0) * 1e3
    pipe_fetches = FETCH_COUNTS["n"] - f0
    pipe_rounds = sum(max(dr.rounds[j] for j in jobs) for _job, jobs in pend)
    if pipe_fetches != pipe_rounds:
        raise AssertionError(f"pipelined: {pipe_fetches} fetches for {pipe_rounds} rounds")
    for group, out in zip(groups, settled):
        for g, s in zip(group, out):
            if parse_answer(das, s) != grounded_answer(host, das, g, False):
                raise AssertionError(f"pipelined answer for {g} differs from numpy")

    # -- the dispatch half must not wait (cache off: both calls dispatch) ------
    cfg = das.db.config
    size, cfg.result_cache_size = cfg.result_cache_size, 0
    held = []
    try:
        q16 = [grounded_query(g) for g in groups[0]]
        dispatch_host_ms, dispatch_card_ms = queued_host_ms(
            lambda: held.append(das.query_many_dispatch(q16)), cycles=1_000_000_000)
        for job in held:
            for g, s in zip(groups[0], job.settle()):
                if parse_answer(das, s) != grounded_answer(host, das, g, False):
                    raise AssertionError(f"queued dispatch: answer for {g} differs from numpy")
    finally:
        cfg.result_cache_size = size
    if dispatch_host_ms * 10 > dispatch_card_ms:
        raise AssertionError(f"query_many_dispatch waited on the card: {dispatch_host_ms} ms "
                             f"of {dispatch_card_ms}")

    # -- the reseed shapes, answered by the exact program ----------------------
    def name(r):
        return data.nodes[host.fin.hex_of_row[r]].name

    triples = host.reseed_triples(args.seed + 3, 16)
    rq = [reseed_query(*map(name, t)) for t in triples]
    rwant = [host.reseed_answer(*t) for t in triples]
    disjoint = sum(not (set(host.procs(a).tolist()) & set(host.procs(b).tolist()))
                   for a, b, _c in triples)
    compiler.reset_route_counts()
    reset_launch_counts()
    with ExactCalls() as exact:
        rout = das.query_many(rq)
        rsingle = [answer_set(das, q)[1] for q in rq]
    reseed_routes = dict(compiler.ROUTE_COUNTS)
    reseed_launches = dict(LAUNCH_COUNTS)
    if reseed_routes["fused"] != 2 * len(rq) or reseed_routes["staged"] or reseed_routes["host"]:
        raise AssertionError(f"reseed shapes left the fused route: {reseed_routes}")
    if exact.n != 2 * disjoint:
        raise AssertionError(f"{exact.n} exact runs for {disjoint} re-seeded shapes, twice")
    row = das.db.fin.row_of_hex
    for i, (s, single, w) in enumerate(zip(rout, rsingle, rwant)):
        got_single = {frozenset((k, row[h]) for k, h in a) for a in single}
        if parse_answer(das, s) != w or got_single != w:
            raise AssertionError(f"reseed shape {i} differs from the reference fold in numpy")

    # -- a batch dispatched before a load settles on the loaded store ----------
    sdata, sgenes = build_kb(SMALL, args.seed)
    shost = HostKB(sdata, sgenes)
    sdas = DistributedAtomSpace(backend="tensor", data=sdata, device=DEVICE)
    proc = sdata.nodes[shost.fin.hex_of_row[int(shost.member[0, 1])]].name
    gname = sdata.nodes[sgenes[0]].name
    from das_tpu_torch.query.ast import Link, Node, Variable

    sq = [Link("Member", [Variable("V1"), Node("BiologicalProcess", proc)], True),
          grounded_query(gname)]
    before = sdas.query_many(sq)
    job = sdas.query_many_dispatch(sq)
    sdas.load_metta_text(f'(: "GENE:loaded" Gene)\n(: "{proc}" BiologicalProcess)\n'
                         f'(Member "GENE:loaded" "{proc}")\n')
    after = job.settle()
    loaded = sdas.db.get_node_handle("Gene", "GENE:loaded")
    if loaded in before[0] or loaded not in after[0] or after != [sdas.query(q) for q in sq]:
        raise AssertionError("the batch dispatched before the load missed the loaded link")
    if len(parse_answer(sdas, after[0])) != len(parse_answer(sdas, before[0])) + 1:
        raise AssertionError("the loaded link did not add exactly one answer")

    emit({
        "phase": "serving", "card": smi,
        "batch": {"entries": len(batch), "duplicates": len(dup), "ms": batch_ms,
                  "per_query_ms": batch_ms / len(batch), "host_fetches": fetches,
                  "retry_rounds": rounds, "routes": routes, "launches": launches,
                  "cache": cache_first},
        "cached": {"ms": cached_ms, "per_query_ms": cached_ms / len(batch),
                   "launches": cached_launches, "host_fetches": 0, "cache": cache_repeat},
        "pipelined": {"groups": len(groups), "per_group": 16, "depth": 2, "ms": pipe_ms,
                      "per_query_ms": pipe_ms / 64, "host_fetches": pipe_fetches,
                      "retry_rounds": pipe_rounds},
        "slice_serial_p50_ms": slice_p50,
        "dispatch_queued": {"queries": 16, "host_ms": dispatch_host_ms,
                            "card_ms": dispatch_card_ms},
        "reseed": {"shapes": len(rq), "re_seeded": disjoint, "exact_runs": exact.n,
                   "routes": reseed_routes, "launches": reseed_launches},
        "stale": {"answers_before": len(parse_answer(sdas, before[0])),
                  "answers_after": len(parse_answer(sdas, after[0]))},
        "cache_stats": result_cache_stats(das.db),
    })
    return launches


def star_rows(args, host):
    """(grounded stars as (g, p1, p2) rows, fan-out processes): p1 and p2
    are two processes of one interaction partner of g, so every grounded
    star's answer is non-empty."""
    rng = random.Random(args.seed + 1)
    stars = []
    for g in rng.sample(sorted(set(host.interacts[:, 0].tolist())), 32):
        x = int(host.partners(g)[0])
        p1, p2 = sorted(host.procs(x).tolist())[:2]
        stars.append((g, p1, p2))
    return stars, rng.sample(sorted(set(host.member[:, 1].tolist())), 8)


def star_families(args, data, genes, host, das):
    """The planned phase's query families: (query, bound names, numpy
    answer) per query (the stars of star_rows)."""

    def name(r):
        return data.nodes[host.fin.hex_of_row[r]].name

    stars, fan = star_rows(args, host)
    chosen = pick_genes(host, [data.nodes[h].name for h in genes], args.seed)
    return {
        "grounded_star": [(grounded_star_query(name(g), name(p1), name(p2)), ("V1",),
                           host.grounded_star(g, p1, p2)) for g, p1, p2 in stars],
        "fanout_star": [(fanout_star_query(name(p)), ("V1", "P2", "V2"), host.fanout_star(p))
                        for p in fan],
        "grounded": [(grounded_query(g), ("V2", "V3"), host.grounded(_gene_row(das, g), False))
                     for g in chosen],
    }


def run_family(das, queries):
    """(answers, host ms per query, host fetches) of one family."""
    from das_tpu_torch.query.fused import FETCH_COUNTS

    f0 = FETCH_COUNTS["n"]
    answers, times = [], []
    for q, names, _want in queries:
        t0 = time.perf_counter()
        answers.append(answer_tuples(das, q, names))
        times.append((time.perf_counter() - t0) * 1e3)
    return answers, times, FETCH_COUNTS["n"] - f0


def phase_planned(das, families):
    """The planned path: grounded stars, fan-out stars and phase slice's grounded
    queries under the default config (use_planner / use_multiway "auto"),
    from a fresh executor.  Counters zeroed just before, read just after."""
    import torch

    from das_tpu_torch import planner
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler

    cfg = das.db.config
    das.db.dev._fused_executor = None
    torch.cuda.synchronize()
    compiler.reset_route_counts()
    planner.reset_planner_counts()
    reset_launch_counts()
    lines = {}
    for fam, queries in families.items():
        r0 = dict(compiler.ROUTE_COUNTS)
        programs = planner.PLANNER_COUNTS["programs"]
        answers, times, fetches = run_family(das, queries)
        lines[fam] = {
            "queries": len(queries), "p50_ms": _p50(times), "host_fetches": fetches,
            "rounds": planner.PLANNER_COUNTS["programs"] - programs,
            "multiway": compiler.ROUTE_COUNTS["fused_multiway"] - r0["fused_multiway"],
            "staged": compiler.ROUTE_COUNTS["staged"] - r0["staged"],
            "nonempty": sum(bool(a[1]) for a in answers), "answers": answers,
        }
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    regimes = regime_counts()
    routes = dict(compiler.ROUTE_COUNTS)
    snap = planner.snapshot()
    if launches["multiway"] == 0:
        raise AssertionError("the multiway kernel never launched on the planned path")
    if routes["host"] != 0:
        raise AssertionError(f"a planned query left the device route: {routes}")
    # the planner's host cost: plan_conjunction alone, statistics warm
    for fam, queries in families.items():
        times = []
        for q, _names, _want in queries:
            plans = compiler.plan_query(das.db, q)
            t0 = time.perf_counter()
            planner.plan_conjunction(das.db, plans)
            times.append((time.perf_counter() - t0) * 1e3)
        lines[fam]["plan_p50_ms"] = _p50(times)

    # -- checks, and the other arms on the same store ---------------------------
    for fam, line in lines.items():
        for (q, names, want), (matched, got) in zip(families[fam], line.pop("answers")):
            if got != want or matched != bool(want):
                raise AssertionError(f"{fam} answer differs from the numpy reference")
        if fam != "grounded" and line["nonempty"] != line["queries"]:
            raise AssertionError(f"{fam}: an answer is empty")
        arms = {"multiway_off": ("auto", "off")}
        if line["multiway"] == 0:
            line["note"] = "auto routed none of this family to multiway at this scale"
            arms["multiway_on"] = ("auto", "on")
        if fam == "grounded":
            arms["planner_off"] = ("off", "off")
        for arm, (use_planner, use_multiway) in arms.items():
            cfg.use_planner, cfg.use_multiway = use_planner, use_multiway
            das.db.dev._fused_executor = None
            try:
                r0 = compiler.ROUTE_COUNTS["fused_multiway"]
                answers, times, fetches = run_family(das, families[fam])
            finally:
                cfg.use_planner, cfg.use_multiway = "auto", "auto"
                das.db.dev._fused_executor = None
            if answers != [(bool(w), w) for _q, _n, w in families[fam]]:
                raise AssertionError(f"{fam} under {arm} differs from the numpy reference")
            line[arm] = {"p50_ms": _p50(times), "host_fetches": fetches,
                         "multiway": compiler.ROUTE_COUNTS["fused_multiway"] - r0}
    emit({"phase": "planned", "families": lines, "routes": routes, "planner": snap,
          "launches": launches, "regimes": regimes})
    return launches


def phase_count_batch(args, das, data, genes, host, width=256):
    """bench.py batched_per_query: `width` grounded queries counted in one
    count_batch call after one warm call (the result cache cleared between,
    so the timed call does the device work).  Counters zeroed just before,
    read just after.  Then a check list, counted on the card and held
    against numpy: 64 grounded queries, 48 of them with non-empty answers,
    and 16 reseed shapes, whose undecided entries only the exact second
    pass answers."""
    import torch

    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.fused import FETCH_COUNTS, get_executor

    gene_names = [data.nodes[h].name for h in genes]
    names = gene_names[:width]
    plans = [compiler.plan_query(das.db, grounded_query(g)) for g in names]
    ex = get_executor(das.db)
    warm = ex.count_batch(plans)
    ex.results.clear()
    b0 = dict(ex.batch_counts)
    torch.cuda.synchronize()
    reset_launch_counts()
    f0 = FETCH_COUNTS["n"]
    t0 = time.perf_counter()
    counts = ex.count_batch(plans)
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    fetches = FETCH_COUNTS["n"] - f0
    batch = {k: ex.batch_counts[k] - b0[k] for k in b0}
    f0 = FETCH_COUNTS["n"]
    t0 = time.perf_counter()
    cached = ex.count_batch(plans)
    cached_ms = (time.perf_counter() - t0) * 1e3
    if FETCH_COUNTS["n"] != f0 or cached != counts or warm != counts:
        raise AssertionError("count_batch: the cached or warm call disagrees")
    if None in counts:
        raise AssertionError("count_batch left a grounded query undecided")
    for g, c in zip(names, counts):
        if c != len(host.grounded(_gene_row(das, g), False)):
            raise AssertionError(f"count_batch: {g} differs from the numpy reference")
    idle = [k for k in ("probe", "index_join", "join_tables") if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the count_batch path: {idle}")

    # -- the check list ---------------------------------------------------------
    def name(r):
        return data.nodes[host.fin.hex_of_row[r]].name

    check = pick_genes(host, gene_names, args.seed + 2, n=64, n_nonempty=48)
    triples = host.reseed_triples(args.seed + 3, 16)
    queries = [grounded_query(g) for g in check] + \
        [reseed_query(*map(name, t)) for t in triples]
    want = [len(host.grounded(_gene_row(das, g), False)) for g in check] + \
        [host.reseed_count(*t) for t in triples]
    ex.results.clear()
    b0 = dict(ex.batch_counts)
    reset_launch_counts()
    got = ex.count_batch([compiler.plan_query(das.db, q) for q in queries])
    torch.cuda.synchronize()
    check_launches = dict(LAUNCH_COUNTS)
    exact_groups = ex.batch_counts["exact_groups"] - b0["exact_groups"]
    wrong = [i for i, (w, c) in enumerate(zip(want, got)) if w != c]
    if wrong:
        raise AssertionError(f"count_batch check list differs from numpy at {wrong}: "
                             f"{[(want[i], got[i]) for i in wrong]}")
    if exact_groups == 0:
        raise AssertionError("no entry of the check list reached the exact second pass")
    nonzero = [i for i in range(len(check)) if got[i]]
    if len(nonzero) < 48:
        raise AssertionError("the check list has fewer than 48 non-zero grounded counts")
    disjoint = len(check) + 1           # the first reseed triple that shares no process
    for i in nonzero[:: len(nonzero) // 3][:3] + [disjoint]:
        if compiler.count_matches(das.db, queries[i]) != got[i]:
            raise AssertionError(f"count_batch differs from count_matches at entry {i}")
    emit({"phase": "count_batch", "queries": width, "ms": ms, "per_query_ms": ms / width,
          "host_fetches": fetches, **batch, "cached_call_ms": cached_ms,
          "nonzero": sum(c > 0 for c in counts), "launches": launches,
          "check": {"entries": len(queries), "nonzero": sum(c > 0 for c in got),
                    "reseeds_re_seeded": sum(not (set(host.procs(a).tolist())
                                                  & set(host.procs(b).tolist()))
                                             for a, b, _c in triples),
                    "exact_groups": exact_groups, "launches": check_launches}})
    return {k: launches[k] + check_launches[k] for k in TPU_KERNELS}


# ---- phase 7 ---------------------------------------------------------------------


def phase_api(args, das, data, genes, host, families, smi):
    """explain and the read surface through the public API on the slice's
    store.  Counters zeroed just before, read just after."""
    import torch

    from das_tpu_torch import planner
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query.fused import FETCH_COUNTS

    t_phase = time.perf_counter()
    gene_names = [data.nodes[h].name for h in genes]
    g = pick_genes(host, gene_names, args.seed, n=1, n_nonempty=1)[0]
    star, fan = families["grounded_star"][0], families["fanout_star"][0]
    cases = {
        "grounded": (grounded_query(g), len(host.grounded(_gene_row(das, g), False))),
        "not": (grounded_query(g, True), len(host.grounded(_gene_row(das, g), True))),
        "grounded_star": (star[0], len(star[2])),
        "fanout_star": (fan[0], len(fan[2])),
    }
    torch.cuda.synchronize()
    reset_launch_counts()
    e0, f0 = planner.PLANNER_COUNTS["explain"], FETCH_COUNTS["n"]
    lines = {}
    for name, (q, want) in cases.items():
        t0 = time.perf_counter()
        plan = das.explain(q)
        plan_ms = (time.perf_counter() - t0) * 1e3
        if not plan["planned"] or len(plan["order"]) != len(q.terms):
            raise AssertionError(f"explain({name}) gave no planned order: {plan}")
        if name.endswith("star") and not plan["multiway"]:
            raise AssertionError(f"explain({name}) planned no multiway step")
        cold = das.explain(q, execute=True)
        t0 = time.perf_counter()
        warm = das.explain(q, execute=True)
        execute_ms = (time.perf_counter() - t0) * 1e3
        for run in (cold, warm):
            if run["actual"] is None or run["actual"]["count"] != want:
                raise AssertionError(f"explain({name}, execute=True) counted "
                                     f"{run['actual']}, numpy {want}")
        if warm["actual"]["retry_rounds"] != 0:
            raise AssertionError(f"explain({name}) with warm capacities retried")
        lines[name] = {
            "route": plan["route"], "method": plan["method"], "multiway": plan["multiway"],
            "order": [t["vars"] for t in plan["order"]], "est_join_rows": plan["est_join_rows"],
            "count": warm["actual"]["count"], "numpy_count": want,
            "join_rows": warm["actual"]["join_rows"],
            "cold_retry_rounds": cold["actual"]["retry_rounds"], "explain_ms": plan_ms,
            "execute_ms": execute_ms,
        }
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    explained = planner.PLANNER_COUNTS["explain"] - e0
    fetches = FETCH_COUNTS["n"] - f0
    if explained != 3 * len(cases):
        raise AssertionError(f"{explained} explain plans for {3 * len(cases)} calls")

    # -- the read surface, against the numpy view in handle space ---------------
    reads = pick_genes(host, gene_names, args.seed + 9, n=8, n_nonempty=4)
    hexes, rows = host.fin.hex_of_row, host.fin.row_of_hex
    times = []
    n_links = 0
    for name in reads:
        gh = das.get_node("Gene", name)
        if (gh != das.db.get_node_handle("Gene", name) or das.get_node_name(gh) != name
                or das.get_node_type(gh) != "Gene"):
            raise AssertionError(f"get_node / get_node_name / get_node_type disagree on {name}")
        t0 = time.perf_counter()
        links = das.get_links("Member", targets=[gh, "*"])
        times.append((time.perf_counter() - t0) * 1e3)
        want = {hexes[p] for p in host.procs(rows[gh]).tolist()}
        got = []
        for link in links:
            targets = das.get_link_targets(link)
            if das.get_link_type(link) != "Member" or targets[0] != gh:
                raise AssertionError(f"get_link_type / get_link_targets disagree on {link}")
            got.append(targets[1])
        if len(got) != len(want) or set(got) != want:
            raise AssertionError(f"get_links(Member, [{name}, *]) differs from numpy")
        n_links += len(links)
    emit({"phase": "api", "card": smi, "explain": lines, "explain_plans": explained,
          "host_fetches": fetches, "launches": launches,
          "read": {"genes": len(reads), "links": n_links, "get_links_p50_ms": _p50(times),
                   "get_links_ms": times},
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ---- phase 8 ---------------------------------------------------------------------


def chain_query(gene_name):
    """Member(g, $V3) and Member($V2, $V3): a grounded chain over {V2, V3}."""
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    return And([Link("Member", [Node("Gene", gene_name), Variable("V3")], True),
                Link("Member", [Variable("V2"), Variable("V3")], True)])


def unordered_template():
    """The unordered Interacts template over two genes {V1, V2}."""
    from das_tpu_torch.query.ast import LinkTemplate, TypedVariable

    return LinkTemplate("Interacts", [TypedVariable("V1", "Gene"),
                                      TypedVariable("V2", "Gene")], False)


def tree_answer(das, query, key):
    """(matched, negation, answers) of a tree query, each answer in `key`
    space: an ordered one as frozenset((variable, key)), a composite one as
    (its ordered part, (each constraint's value set, ...)), an unordered one
    as ("U", its value set)."""
    matched, answer = das.query_answer(query)
    out = set()
    for a in answer.assignments:
        if hasattr(a, "unordered_mappings"):
            om = a.ordered_mapping.mapping if a.ordered_mapping is not None else {}
            out.add((frozenset((k, key(h)) for k, h in om.items()),
                     tuple(frozenset(key(h) for h in u.values) for u in a.unordered_mappings)))
        elif hasattr(a, "symbols"):
            out.add(("U", frozenset(key(h) for h in a.values)))
        else:
            out.add(frozenset((k, key(h)) for k, h in a.mapping.items()))
    return bool(matched), answer.negation, out


def animal_queries():
    """The animals KB's tree-phase queries: the unordered Similarity probe
    of ten concepts, a conjunction over it and an Or."""
    from das_tpu_torch.query.ast import And, Link, Node, Or, Variable

    names = ["human", "monkey", "chimp", "snake", "earthworm", "rhino", "triceratops",
             "vine", "ent", "mammal"]

    def sim(*targets):
        return Link("Similarity", list(targets), False)

    queries = [sim(Node("Concept", n), Variable("V1")) for n in names]
    queries += [And([sim(Variable("V1"), Variable("V2")),
                     Link("Inheritance", [Variable("V1"), Node("Concept", "mammal")], True)]),
                Or([Link("Inheritance", [Variable("V1"), Node("Concept", "plant")], True),
                    sim(Variable("V1"), Node("Concept", "snake"))])]
    return queries


class TreeRounds:
    """While active, counts whole-tree job dispatches (one round each)."""

    def __enter__(self):
        from das_tpu_torch.query import fused

        self.n = 0
        self._fn = fn = fused._TreeExecJob.dispatch

        def dispatch(job):
            self.n += 1
            return fn(job)

        fused._TreeExecJob.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from das_tpu_torch.query import fused

        fused._TreeExecJob.dispatch = self._fn
        return False


def tree_families(host, das, data, genes, seed, width=16):
    """The tree phase's query families on the FlyBase-shaped store:
    {name: [(query, numpy answer set, negation)]}, `width` queries each, the
    answers as frozenset((variable, row)) (composites as tree_answer gives
    them)."""
    from das_tpu_torch.query.ast import And, Link, Node, Not, Or, Variable

    gene_names = [data.nodes[h].name for h in genes]
    picks = pick_genes(host, gene_names, seed + 11, n=3 * width, n_nonempty=width)
    row = {g: _gene_row(das, g) for g in picks}

    def chain(g):
        r = row[g]
        return {frozenset({("V2", m), ("V3", p)})
                for p in host.procs(r).tolist() for m in host.members(p).tolist()}

    fam = {"or2": [], "or3": [], "or_not": [], "or_mixed": [], "and_or": [], "unordered": []}
    for i in range(width):
        a, b, c = picks[i], picks[width + i], picks[2 * width + i]
        fam["or2"].append((Or([chain_query(a), chain_query(b)]), chain(a) | chain(b), False))
        fam["or3"].append((Or([chain_query(a), chain_query(b), chain_query(c)]),
                           chain(a) | chain(b) | chain(c), False))
        fam["or_not"].append((Or([chain_query(a), Not(chain_query(b))]),
                              chain(b) - chain(a), True))
        partners_b = {frozenset({("V5", x)}) for x in host.partners(row[b]).tolist()}
        fam["or_mixed"].append((
            Or([chain_query(a), Link("Interacts", [Node("Gene", b), Variable("V5")], True)]),
            chain(a) | partners_b, False))
        # a has an interaction partner sharing one of its processes
        partners_a = set(host.partners(row[a]).tolist())
        fam["and_or"].append((
            And([Or([chain_query(a), chain_query(b)]),
                 Link("Interacts", [Node("Gene", a), Variable("V2")], True)]),
            {s for s in chain(a) | chain(b) if dict(s)["V2"] in partners_a}, False))
        fam["unordered"].append((
            And([Link("Interacts", [Node("Gene", a), Variable("V1")], True),
                 unordered_template()]),
            {(frozenset({("V1", p)}), (frozenset({p, x}),))
             for p in set(host.partners(row[a]).tolist())
             for x in set(host.partners(p).tolist())}, False))
    return fam


def phase_tree(args, das, data, genes, host, large, smi):
    """The tree executor on the card: Ors of grounded chains (the whole-tree
    job), a Not branch, an Or over different variable sets and an And over
    an Or (the staged tree), an unordered Interacts template joined to a
    grounded Interacts term (FlyBase-shaped) and to a grounded Member term
    (LARGE), and the animals Similarity links; every answer against numpy
    or the host algebra; count_matches, explain, the result cache across a
    commit (SMALL), a whole-tree dispatch queued behind a sleep kernel, and
    get_links through the device probes against MemoryDB's host scan.
    Counters zeroed just before each family, read just after."""
    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.query import compiler, fused, plan, tree
    from das_tpu_torch.query.ast import And, Link, Node, Or, Variable
    from das_tpu_torch.storage.atom_table import load_metta_text
    from das_tpu_torch.storage.memory_db import MemoryDB

    t_phase = time.perf_counter()
    total = dict.fromkeys(TPU_KERNELS, 0)
    row = das.db.fin.row_of_hex.__getitem__
    fams = tree_families(host, das, data, genes, args.seed)
    # the grounded Member term against the whole unordered template, on
    # LARGE: its O x U join is a cross product (the reference's composite
    # join), |members(p)| x 15,000 pairs here; at FlyBase shape 133 x
    # 150,000 rows would pass max_result_capacity
    ldas, ldata, lgenes = large
    lhost = HostKB(ldata, lgenes)
    lrow = ldas.db.fin.row_of_hex.__getitem__
    lprocs = sorted(set(lhost.member[:, 1].tolist()))[:16]
    lname = {p: ldata.nodes[lhost.fin.hex_of_row[p]].name for p in lprocs}
    fams["unordered_member"] = [
        (And([Link("Member", [Variable("V1"), Node("BiologicalProcess", lname[p])], True),
              unordered_template()]),
         {(frozenset({("V1", m)}), (frozenset({m, x}),))
          for m in set(lhost.members(p).tolist()) for x in set(lhost.partners(m).tolist())},
         False)
        for p in lprocs]
    fused_families = ("or2", "or3", "or_not")
    lines = {}
    torch.cuda.synchronize()
    for name, cases in fams.items():
        target, key = (ldas, lrow) if name == "unordered_member" else (das, row)
        compiler.reset_route_counts()
        reset_launch_counts()
        f0 = fused.FETCH_COUNTS["n"]
        times = []
        answers = 0
        with TreeRounds() as rounds, DispatchRounds() as conj:
            for q, want, negation in cases:
                t0 = time.perf_counter()
                matched, neg, got = tree_answer(target, q, key)
                times.append((time.perf_counter() - t0) * 1e3)
                if got != want or neg != negation or matched != bool(want or negation):
                    raise AssertionError(f"tree family {name}: an answer differs from numpy "
                                         f"({len(got)} rows, numpy {len(want)})")
                answers += len(got)
        torch.cuda.synchronize()
        launches = dict(LAUNCH_COUNTS)
        routes = dict(compiler.ROUTE_COUNTS)
        fetches = fused.FETCH_COUNTS["n"] - f0
        for k in total:
            total[k] += launches[k]
        if routes["host"] or routes["tree"] != len(cases):
            raise AssertionError(f"tree family {name} left the tree route: {routes}")
        if name in fused_families:
            if routes["fused_tree"] != len(cases) or fetches != rounds.n:
                raise AssertionError(f"tree family {name}: {routes['fused_tree']} fused_tree "
                                     f"answers, {fetches} fetches for {rounds.n} rounds")
        elif routes["fused_tree"]:
            raise AssertionError(f"tree family {name} took the whole-tree job")
        for q, want, _neg in cases:
            if compiler.count_matches(target.db, q) != len(want):
                raise AssertionError(f"tree family {name}: count_matches differs from numpy")
        lines[name] = {
            "queries": len(cases), "answers": answers, "p50_ms": _p50(times),
            "p90_ms": sorted(times)[int(len(times) * 0.9)], "host_fetches": fetches,
            "tree_rounds": rounds.n, "conj_rounds": sum(conj.rounds.values()),
            "routes": {k: v for k, v in routes.items() if v},
            "launches": {k: launches[k] for k in TPU_KERNELS},
        }

    # -- a repeated family is a cache hit: no launch, no fetch ------------------
    repeats = {}
    for name in ("or2", "or_mixed"):
        reset_launch_counts()
        f0 = fused.FETCH_COUNTS["n"]
        for q, want, _neg in fams[name]:
            if tree_answer(das, q, row)[2] != want:
                raise AssertionError(f"repeated tree family {name} differs from numpy")
        torch.cuda.synchronize()
        repeats[name] = {"launches": sum(LAUNCH_COUNTS.values()),
                         "host_fetches": fused.FETCH_COUNTS["n"] - f0}
        if repeats[name]["launches"] or repeats[name]["host_fetches"]:
            raise AssertionError(f"repeated tree family {name} was no cache hit: {repeats[name]}")

    # -- explain of the fused, the staged and the unordered shape --------------
    explained = {}
    for name, route in (("or2", "fused_tree"), ("or_mixed", "tree"), ("unordered", "tree")):
        q, want, _neg = fams[name][0]
        plan_only = das.explain(q)
        run = das.explain(q, execute=True)
        if plan_only["route"] != route or run["route"] != route:
            raise AssertionError(f"explain({name}) routes {plan_only['route']}, not {route}")
        if route == "fused_tree":
            counts = [run["actual"]["count"]]
            if counts != [len(want)]:
                raise AssertionError(f"explain({name}, execute=True) counted {counts[0]}, "
                                     f"numpy {len(want)}")
        else:
            counts = [s["actual"]["count"] for s in run["sites"]]
            # or_mixed's one conjunction site is its chain; the unordered
            # shape has none
            want_sites = ([len([s for s in want if "V3" in dict(s)])]
                          if name == "or_mixed" else [])
            if counts != want_sites:
                raise AssertionError(f"explain({name}, execute=True) site counts {counts}, "
                                     f"numpy {want_sites}")
        explained[name] = {"route": run["route"], "planned": run["planned"], "counts": counts}

    # -- the whole-tree dispatch does not wait for the card ---------------------
    q, want, _neg = fams["or3"][1]
    pos_sites, neg_plans, _const = tree.tree_fusion_sites(plan.build_plan(das.db, q))
    job = fused.get_executor(das.db).tree_exec_job(pos_sites, neg_plans)
    held = []
    reset_launch_counts()
    dispatch_host_ms, dispatch_card_ms = queued_host_ms(
        lambda: held.append(job.dispatch()), cycles=1_000_000_000)
    for k in total:
        total[k] += LAUNCH_COUNTS[k]
    if dispatch_host_ms * 10 > dispatch_card_ms:
        raise AssertionError(f"the tree job's dispatch waited on the card: "
                             f"{dispatch_host_ms} ms of {dispatch_card_ms}")
    out = held[-1]
    if not job.settle(fused.fetch(*out), out) or job.result is None:
        raise AssertionError("the queued tree job did not settle in its round")
    got = {frozenset(zip(job.result.var_names, r))
           for r in job.result.host_vals[job.result.host_valid].tolist()}
    if got != want:
        raise AssertionError("the queued tree job's table differs from numpy")

    # -- animals: the unordered Similarity probes, against the host algebra -----
    adas = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                                device=DEVICE)
    amem = DistributedAtomSpace(backend="memory", data=load_metta_text(animals_metta()))
    animal_qs = animal_queries()
    reset_launch_counts()
    similar = 0
    animal_routes = dict.fromkeys(compiler.ROUTE_COUNTS, 0)
    for q in animal_qs:
        r0 = dict(compiler.ROUTE_COUNTS)
        got = tree_answer(adas, q, str)
        for k, v in compiler.ROUTE_COUNTS.items():
            animal_routes[k] += v - r0[k]
        want = tree_answer(amem, q, str)
        if got != want:
            raise AssertionError(f"animals: {q} differs from the host algebra")
        if compiler.count_matches(adas.db, q) != len(want[2]):
            raise AssertionError(f"animals: count_matches of {q} differs")
        similar += len(got[2])
    for k in total:
        total[k] += LAUNCH_COUNTS[k]
    if animal_routes["host"] or animal_routes["tree"] != len(animal_qs):
        raise AssertionError(f"animals left the tree route: {animal_routes}")
    ordered_similarity = Or([Link("Inheritance", [Variable("V1"), Variable("V2")], True),
                             Link("Similarity", [Variable("V1"), Variable("V2")], True)])
    if compiler.count_matches(adas.db, ordered_similarity) is not None:
        raise AssertionError("count_matches counted a query the tree planner cannot plan")

    # -- SMALL: a cached tree answer and a commit -------------------------------
    sdas = DistributedAtomSpace(backend="tensor", data=build_kb(SMALL, args.seed)[0],
                                device=DEVICE)
    smem = DistributedAtomSpace(backend="memory", data=build_kb(SMALL, args.seed)[0])
    sg = sdas.db.get_all_nodes("Gene", names=True)[:2]
    sq = [Or([chain_query(sg[0]), chain_query(sg[1])]),
          Or([chain_query(sg[0]), Link("Interacts", [Node("Gene", sg[1]), Variable("V5")],
                                       True)])]
    sbefore = [tree_answer(sdas, q, str) for q in sq]
    proc = sdas.db.get_link_targets(sdas.get_links("Member", targets=[
        sdas.db.get_node_handle("Gene", sg[0]), "*"])[0])[1]
    pname = sdas.db.get_node_name(proc)
    text = (f'(: "GENE:tree" Gene)\n(: "{sg[1]}" Gene)\n(: "{pname}" BiologicalProcess)\n'
            f'(Member "GENE:tree" "{pname}")\n(Interacts "{sg[1]}" "GENE:tree")\n')
    inval0 = fused.result_cache_stats(sdas.db)["invalidations"]
    sdas.load_metta_text(text)
    smem.load_metta_text(text)
    safter = [tree_answer(sdas, q, str) for q in sq]
    if safter != [tree_answer(smem, q, str) for q in sq]:
        raise AssertionError("SMALL: a tree answer after the commit differs from the host algebra")
    if any(a == b for a, b in zip(safter, sbefore)):
        raise AssertionError("SMALL: a tree answer did not change with the commit (stale)")
    if fused.result_cache_stats(sdas.db)["invalidations"] <= inval0:
        raise AssertionError("SMALL: the commit invalidated no tree cache entry")

    # -- get_links through the device probes against MemoryDB's host scan -------
    reads = pick_genes(host, [data.nodes[h].name for h in genes], args.seed + 13, n=8,
                       n_nonempty=4)
    device_ms, scan_ms = [], []
    # a TensorDB keeps no host scan lists: MemoryDB over the same records does
    scan_db = MemoryDB(das.data)
    for name in reads:
        gh = das.db.get_node_handle("Gene", name)
        t0 = time.perf_counter()
        handles = das.get_links("Member", targets=[gh, "*"])
        device_ms.append((time.perf_counter() - t0) * 1e3)
        got = das.db.get_matched_links("Member", [gh, "*"])
        t0 = time.perf_counter()
        scanned = scan_db.get_matched_links("Member", [gh, "*"])
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        if sorted(got) != sorted(scanned) or sorted(handles) != sorted(h for h, _ in scanned):
            raise AssertionError(f"get_links(Member, [{name}, *]) differs from the host scan")
    emit({"phase": "tree", "card": smi, "families": lines, "repeats": repeats,
          "explain": explained,
          "queued_dispatch": {"host_ms": dispatch_host_ms, "card_ms": dispatch_card_ms},
          "animals": {"queries": len(animal_qs), "answers": similar, "routes": {
              k: v for k, v in animal_routes.items() if v}},
          "small_commit": {"answers_before": [len(a[2]) for a in sbefore],
                           "answers_after": [len(a[2]) for a in safter]},
          "get_links": {"genes": len(reads), "device_p50_ms": _p50(device_ms),
                        "host_scan_p50_ms": _p50(scan_ms), "device_ms": device_ms,
                        "host_scan_ms": scan_ms},
          "launches": total, "phase_s": time.perf_counter() - t_phase})
    return total


# ---- phase entry -------------------------------------------------------------------


def shim_family_queries(data, host, args, pm):
    """Phase entry's shim families on phase kb's store, each query as a
    pair (built from the `das` shim's routed classes, built from the
    port's own): grounded and Not over 8 genes with answers, fan-out stars
    over 4 processes."""
    from das_tpu_torch.query import ast

    def grounded(m, g, negate):
        third = m.Link("Interacts", [m.Node("Gene", g), m.Variable("V2")], True)
        return m.And([m.Link("Member", [m.Node("Gene", g), m.Variable("V3")], True),
                      m.Link("Member", [m.Variable("V2"), m.Variable("V3")], True),
                      m.Not(third) if negate else third])

    def fanout(m, p):
        return m.And([m.Link("Member", [m.Variable("V1"), m.Node("BiologicalProcess", p)], True),
                      m.Link("Member", [m.Variable("V1"), m.Variable("P2")], True),
                      m.Link("Interacts", [m.Variable("V1"), m.Variable("V2")], True)])

    gene_names = [data.nodes[host.fin.hex_of_row[r]].name for r in host.gene_rows.tolist()]
    genes = pick_genes(host, gene_names, args.seed + 41, n=8, n_nonempty=8)
    procs = [data.nodes[host.fin.hex_of_row[r]].name for r in star_rows(args, host)[1][:4]]
    return {
        "grounded": [(grounded(pm, g, False), grounded(ast, g, False)) for g in genes],
        "not": [(grounded(pm, g, True), grounded(ast, g, True)) for g in genes],
        "fanout_star": [(fanout(pm, p), fanout(ast, p)) for p in procs],
    }


def split_merged_trace(events):
    """(the profiler's events, the recorder's events) of a Chrome trace
    that obs/torchprof.py `merge_recorder` wrote: the recorder's lanes
    are the integer pids from OBS_PID_BASE up (the profiler's pids are
    process ids, device indices or strings)."""
    from das_tpu_torch.obs.torchprof import OBS_PID_BASE

    def recorder(e):
        pid = e.get("pid")
        return isinstance(pid, int) and pid >= OBS_PID_BASE

    return ([e for e in events if not recorder(e)], [e for e in events if recorder(e)])


def check_one_clock(events):
    """The merged trace's clock holds: every kernel or copy launched from
    inside a `serve.dispatch` span starts on the card after that span's
    start, those launches come from one host thread (the worker's), and
    every launch of that thread lies inside one of its `serve.dispatch`
    or `serve.settle` spans (a clock off by more than a span's length
    puts launches outside them).  Returns the launches checked and the
    nearest start's lead in us."""
    xs = [e for e in events if e.get("ph") == "X"]
    launch = {(e.get("args") or {}).get("correlation"): e for e in xs
              if e.get("cat") == "cuda_runtime"}
    dispatch = [e for e in xs if e.get("name") == "serve.dispatch"]
    worker = [e for e in xs if e.get("name") in ("serve.dispatch", "serve.settle")]

    def within(t, spans):
        return [s for s in spans if s["ts"] <= t <= s["ts"] + s["dur"]]

    calls, inside, tids, lead = [], 0, set(), None
    for k in (e for e in xs if e.get("cat") in ("kernel", "gpu_memcpy")):
        call = launch.get((k.get("args") or {}).get("correlation"))
        if call is None:
            continue
        calls.append(call)
        for d in within(call["ts"], dispatch):
            if k["ts"] < d["ts"]:
                raise AssertionError(f"merged trace: {k['name']} starts at {k['ts']} us, "
                                     f"before its serve.dispatch at {d['ts']} us")
            inside += 1
            tids.add(call["tid"])
            lead = k["ts"] - d["ts"] if lead is None else min(lead, k["ts"] - d["ts"])
    if inside == 0 or len(tids) != 1:
        raise AssertionError(f"merged trace: {inside} launches inside serve.dispatch spans, "
                             f"from threads {sorted(tids)}")
    outside = [c for c in calls if c["tid"] in tids and not within(c["ts"], worker)]
    if outside:
        raise AssertionError(f"merged trace: {len(outside)} of the worker's launches lie "
                             f"outside its dispatch and settle spans")
    return {"dispatch_launches": inside, "nearest_lead_us": lead}


def phase_entry(args, das, data, host, smi):
    """The entry points beside the package on the card (the docstring's
    phase entry).  Counters zeroed just before each driven part, read just
    after; returns the phase's launches per kernel."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from das_tpu_torch import obs
    from das_tpu_torch.convert import dump as dump_mod
    from das_tpu_torch.ingest import native
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.models.bio import write_bio_canonical
    from das_tpu_torch.obs.registry import SPAN_NAMES
    from das_tpu_torch.query import compiler

    root = os.path.dirname(os.path.abspath(__file__))
    for sub in ("scripts", "compat_torch"):
        if os.path.join(root, sub) not in sys.path:
            sys.path.insert(0, os.path.join(root, sub))
    import dump_das_torch
    import dump_trace_torch
    import load_das_torch
    import regression_torch
    from das.pattern_matcher import pattern_matcher as pm

    t_phase = time.perf_counter()
    total = dict.fromkeys(TPU_KERNELS, 0)

    def counted(fn):
        """fn() with the launch counts zeroed just before, read just after."""
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS}
        for k in TPU_KERNELS:
            total[k] += got[k]
        return out, got

    # -- (a) the battery ----------------------------------------------------------------
    expected = regression_torch.EXPECTED.read_text()
    memory = regression_torch.run(regression_torch.animals_das("memory"))
    if regression_torch.differing_blocks(memory, expected):
        raise AssertionError("the MemoryDB battery differs from das_tpu's expected output")
    tensor_das = regression_torch.animals_das("tensor", DEVICE)
    runs = {
        "tensor": lambda: regression_torch.run(tensor_das),
        "tensor_shim": lambda: regression_torch.run(tensor_das, pm),
        "sharded": lambda: regression_torch.run(
            regression_torch.animals_das("sharded", DEVICE, shards=8)),
    }
    battery = {}
    for name, fn in runs.items():
        t0 = time.perf_counter()
        out, got = counted(fn)
        wall = time.perf_counter() - t0
        blocks = len(regression_torch.normalize_regression_output(out))
        bad = (regression_torch.differing_blocks(out, expected),
               regression_torch.differing_blocks(out, memory))
        if blocks != regression_torch.N_BLOCKS or any(bad):
            raise AssertionError(f"battery on {name}: {blocks} blocks, differing {bad}")
        if not got["probe"]:
            raise AssertionError(f"battery on {name} launched no probe")
        battery[name] = {"blocks": blocks, "s": wall, "launches": got}

    # -- (b) the shim's routed classes on phase kb's store ------------------------------
    families = shim_family_queries(data, host, args, pm)
    shim = {}
    for fam, pairs in families.items():
        facade_ms, shim_ms, want, got_sets = [], [], [], []
        shim_launches = dict.fromkeys(TPU_KERNELS, 0)
        routes = {}

        def facade(q):
            t0 = time.perf_counter()
            _m, ans = das.query_answer(q)
            facade_ms.append((time.perf_counter() - t0) * 1e3)
            want.append({frozenset(a.mapping.items()) for a in ans.assignments})

        def routed(sq):
            """One shim call, its launches and routes counted apart from
            the facade's."""
            launches0, routes0 = dict(LAUNCH_COUNTS), dict(compiler.ROUTE_COUNTS)
            ans = pm.PatternMatchingAnswer()
            t0 = time.perf_counter()
            sq.matched(das.db, ans)
            shim_ms.append((time.perf_counter() - t0) * 1e3)
            got_sets.append({frozenset(a.mapping.items()) for a in ans.assignments})
            for k in TPU_KERNELS:
                shim_launches[k] += LAUNCH_COUNTS[k] - launches0[k]
            for k, v in compiler.ROUTE_COUNTS.items():
                if v - routes0.get(k, 0):
                    routes[k] = routes.get(k, 0) + v - routes0.get(k, 0)

        def family():
            # each side goes first on every other query, so neither times
            # the other's warm-up
            for i, (sq, q) in enumerate(pairs):
                if i % 2:
                    routed(sq)
                    facade(q)
                else:
                    facade(q)
                    routed(sq)

        counted(family)
        if got_sets != want:
            raise AssertionError(f"shim family {fam}: answers differ from query_answer's")
        if not any(want):
            raise AssertionError(f"shim family {fam}: no query has an answer")
        if (routes.get("host") or not shim_launches["probe"]
                or (fam == "not" and not shim_launches["anti_join"])):
            raise AssertionError(f"shim family {fam} did not run on the card: {routes} "
                                 f"{shim_launches}")
        shim[fam] = {"queries": len(pairs), "answers": [len(a) for a in want],
                     "shim_p50_ms": _p50(shim_ms), "facade_p50_ms": _p50(facade_ms),
                     "shim_ms": shim_ms, "facade_ms": facade_ms,
                     "routes": routes, "launches": shim_launches}

    # -- (c) the CLIs -------------------------------------------------------------------
    work = tempfile.mkdtemp(prefix="das_entry_")
    kb_file = os.path.join(work, "small.metta")
    write_bio_canonical(kb_file, seed=args.seed, **SMALL)
    # the scanner's build, on a fresh checkout a g++ run, is timed apart from
    # the load (phase ingest then finds it built)
    prebuilt = native.library_path().exists()
    t0 = time.perf_counter()
    native.build()
    scanner_build_s = time.perf_counter() - t0
    ckpt = os.path.join(work, "small_ckpt")
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        if load_das_torch.run(["--knowledge-base", kb_file, "--canonical",
                               "--checkpoint", ckpt, "--device", DEVICE]) != 0:
            raise AssertionError("load_das_torch.py failed")
        load_s = time.perf_counter() - t0
        # the dump reads the host tables alone: the checkpoint that the load
        # wrote (the native scanner's columnar store) against the generator's
        # own build of the same KB, with no file and no scanner
        dump_das_torch.main(["dump", "--checkpoint", ckpt, os.path.join(work, "cli", "small")])
    want_data, _ = build_kb(SMALL, args.seed)
    dump_mod.dump_store(want_data, os.path.join(work, "small"))
    names = sorted(f.split(".", 1)[1] for f in os.listdir(os.path.join(work, "cli")))
    for coll in names:
        with open(os.path.join(work, "cli", f"small.{coll}"), "rb") as a, \
                open(os.path.join(work, f"small.{coll}"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"dump_das_torch.py's {coll} differs from the "
                                     f"generator's dump")
    if "links_2" not in names or want_data.count_atoms()[1] == 0:
        raise AssertionError(f"the small canonical store dumped nothing: {names}")
    trace_path = os.path.join(work, "trace.json")
    try:
        with contextlib.redirect_stdout(text):
            _out, trace_launches = counted(lambda: dump_trace_torch.main(
                ["-o", trace_path, "--clients", "4", "--scale", "0.05", "--device", DEVICE]))
    finally:
        obs.configure(enabled=False)
        obs.proflog.configure(enabled=False)
        obs.reset()
        obs.proflog.reset()
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    # on the card the file is the profiler's trace with the recorder's
    # events merged in: the span names are the recorder's lanes'
    clock = None
    if DEVICE != "cpu":
        clock = check_one_clock(events)
        events = split_merged_trace(events)[1]
    spans = {e["name"] for e in events} - {"process_name", "thread_name"}
    need = {"serve.submit", "serve.plan", "serve.dispatch", "serve.settle", "serve.answer",
            "exec.dispatch", "exec.materialize", "exec.format", "serve.idle", "cache.hit",
            "commit.delta", "prof.compile"}
    if not spans <= set(SPAN_NAMES) or not need <= spans:
        raise AssertionError(f"dump_trace_torch.py's spans: {sorted(spans)}")
    emit({"phase": "entry", "card": smi, "battery": battery, "shim": shim,
          "cli": {"canonical_atoms": list(want_data.count_atoms()),
                  "scanner_build_s": scanner_build_s, "scanner_prebuilt": prebuilt,
                  "load_s": load_s,
                  "dump_collections": names, "trace_spans": sorted(spans),
                  "trace_launches": trace_launches, "trace_clock": clock},
          "launches": total, "phase_s": time.perf_counter() - t_phase})
    shutil.rmtree(work, ignore_errors=True)
    return total


# ---- phase 9 ---------------------------------------------------------------------


# ---- phase sharded -----------------------------------------------------------------

#: slabs of phase sharded's stores (all on the one card)
SHARDS = 8


def template_join_query(gene_name):
    """Interacts(g, $V1) and the ordered Interacts template over {V1, V2}:
    the template term is materialized (no index join), so on the mesh its
    join hash-partitions both sides."""
    from das_tpu_torch.query.ast import And, Link, LinkTemplate, Node, TypedVariable, Variable

    return And([Link("Interacts", [Node("Gene", gene_name), Variable("V1")], True),
                LinkTemplate("Interacts", [TypedVariable("V1", "Gene"),
                                           TypedVariable("V2", "Gene")], True)])


def answer_rowsets(das, query):
    """{frozenset((variable, row))} of an answer (empty when unmatched)."""
    matched, answer = das.query_answer(query)
    row = das.db.fin.row_of_hex
    got = {frozenset((k, row[h]) for k, h in a.mapping.items()) for a in answer.assignments}
    return got if matched else set()


class JoinKinds:
    """While active, counts the steps of every sharded plan signature run,
    by collective: index joins, broadcast-right joins, hash-partitioned
    joins and multiway steps."""

    def __enter__(self):
        from das_tpu_torch.parallel import fused_sharded as fs

        self.n = {"index": 0, "broadcast": 0, "partitioned": 0, "multiway": 0}
        self._fn = fn = fs.run_sharded_conj

        def run(sig, *a):
            step0 = 1 if sig.multiway else 0
            self.n["multiway"] += step0
            for t, q in enumerate(sig.exch_caps[step0:]):
                if sig.index_joins and sig.index_joins[t] >= 0:
                    self.n["index"] += 1
                elif q > 0:
                    self.n["partitioned"] += 1
                else:
                    self.n["broadcast"] += 1
            return fn(sig, *a)

        fs.run_sharded_conj = run
        return self

    def __exit__(self, *exc):
        from das_tpu_torch.parallel import fused_sharded as fs

        fs.run_sharded_conj = self._fn
        return False


def slab_rows(fin, tables):
    """Per arity and slab, the sorted (type, target...) rows of the slabs in
    handle space, each handle and type name as its hash in this process
    (row ids differ between an incrementally committed store and a
    re-partition)."""
    atom = np.fromiter((hash(h) for h in fin.hex_of_row), np.int64, len(fin.hex_of_row))
    types = np.fromiter((hash(t) for t in fin.type_names), np.int64, len(fin.type_names))
    out = {}
    for arity, b in tables.buckets.items():
        for s in range(b.n_shards):
            n = int(b.slab_sizes[s])
            tg = b.targets[s][:n].cpu().numpy()
            cols = [types[b.type_id[s][:n].cpu().numpy()]] + [atom[tg[:, p]] for p in range(arity)]
            rows = np.stack(cols, axis=1)
            out[(arity, s)] = rows[np.lexsort(rows.T[::-1])]
    return out


def check_slab_indexes(b):
    """Every slab-local sorted index of a bucket: keys non-decreasing over
    the slab's rows and the int64 max after them, perm a permutation of the
    rows, each key the key of the row perm points to."""
    I64 = np.iinfo(np.int64).max
    for s in range(b.n_shards):
        n = int(b.slab_sizes[s])
        tid = b.type_id[s].cpu().numpy()[:n].astype(np.int64)
        tg = b.targets[s].cpu().numpy()[:n].astype(np.int64)
        cols = [("key_type", "order_by_type", lambda r: tid[r])]
        for p in range(b.arity):
            cols.append((("key_type_pos", p), ("order_by_type_pos", p),
                         lambda r, p=p: (tid[r] << 32) | tg[r, p]))
            cols.append((("key_pos", p), ("order_by_pos", p), lambda r, p=p: tg[r, p]))
        for kname, oname, key_of in cols:
            get = (lambda f: getattr(b, f)[s]) if isinstance(kname, str) else \
                (lambda f: getattr(b, f[0])[f[1]][s])
            keys, perm = get(kname).cpu().numpy(), get(oname).cpu().numpy()
            if (np.diff(keys[:n]) < 0).any() or (keys[n:] != I64).any():
                raise AssertionError(f"slab {s} {kname}: keys out of order")
            if not np.array_equal(np.sort(perm[:n]), np.arange(n)):
                raise AssertionError(f"slab {s} {oname}: not a permutation")
            if not np.array_equal(keys[:n], key_of(perm[:n])):
                raise AssertionError(f"slab {s} {kname}: a key is not its row's")


def phase_sharded(args, das, data, genes, host, families, large, smi):
    """The sharded store on the card: the FlyBase-shaped KB of phase kb
    (built again from the same configuration and seed, so that this
    phase's commit leaves the tensor store's data alone) dealt over 8 slabs
    on the one card, DistributedAtomSpace(backend="sharded"); the slice's
    families against the tensor store's answers and numpy, p50 beside the
    tensor store's from this run; the collectives each plan step took; one
    query_many batch and the same batch from the cache; the tree families
    and the animals Similarity links; one 256-gene commit with its slabs
    held against a re-partition in handle space; on SMALL a snapshot and
    restore with every slab bit-equal.  Counters zeroed just before the
    main path, read just after."""
    import shutil
    import tempfile

    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.parallel.fused_sharded import get_sharded_executor
    from das_tpu_torch.parallel.sharded_db import ShardedTables
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.fused import FETCH_COUNTS, result_cache_stats
    from das_tpu_torch.storage.atom_table import load_metta_text

    t_phase = time.perf_counter()
    cfg = scaled(FLYBASE, args.scale)
    t0 = time.perf_counter()
    sdata, sgenes = build_kb(cfg, args.seed)
    build_s = time.perf_counter() - t0
    mesh_cfg = lambda **kw: DasConfig(mesh_shape=(SHARDS,), **kw)  # noqa: E731
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sdas = DistributedAtomSpace(backend="sharded", data=sdata, device=DEVICE, config=mesh_cfg())
    torch.cuda.synchronize()
    partition_upload_s = time.perf_counter() - t0
    store_bytes = torch.cuda.memory_allocated() - mem0
    db = sdas.db
    if db.tables.n_shards != SHARDS or db.fin.hex_of_row != das.db.fin.hex_of_row:
        raise AssertionError("the sharded store's rows differ from phase kb's store")

    # -- the families: (name, [(query, bound names, numpy answer)]) ---------
    gene_names = [data.nodes[h].name for h in genes]
    chosen = pick_genes(host, gene_names, args.seed + 21, n=16, n_nonempty=8)
    name_of_row = lambda r: data.nodes[host.fin.hex_of_row[r]].name  # noqa: E731
    fams = {
        "grounded": [(grounded_query(g), ("V2", "V3"), host.grounded(_gene_row(das, g), False))
                     for g in chosen],
        "not": [(grounded_query(g, True), ("V2", "V3"), host.grounded(_gene_row(das, g), True))
                for g in chosen],
        "grounded_star": families["grounded_star"][:16],
        "fanout_star": families["fanout_star"],
        "template_join": [
            (template_join_query(g), ("V1", "V2"),
             {(x, y) for x in set(host.partners(_gene_row(das, g)).tolist())
              for y in set(host.partners(x).tolist())})
            for g in chosen[:8]],
    }
    reseeds = [
        (reseed_query(*(name_of_row(r) for r in t)), host.reseed_answer(*t))
        for t in host.reseed_triples(args.seed + 22, 8)]
    ldas, ldata, lgenes = large
    lsdas = DistributedAtomSpace(backend="sharded", data=ldata, device=DEVICE, config=mesh_cfg())

    # -- the tensor store's p50 on the same queries (its launches are not
    # this path's)
    tensor_p50 = {}
    for name, cases in fams.items():
        times = []
        for q, names, _want in cases:
            t0 = time.perf_counter()
            answer_tuples(das, q, names)
            times.append((time.perf_counter() - t0) * 1e3)
        tensor_p50[name] = _p50(times)
    times = []
    for q, _want in reseeds:
        t0 = time.perf_counter()
        answer_rowsets(das, q)
        times.append((time.perf_counter() - t0) * 1e3)
    tensor_p50["reseed"] = _p50(times)

    # -- the main path on the mesh: counters zeroed just before ------------
    torch.cuda.synchronize()
    compiler.reset_route_counts()
    reset_launch_counts()
    fetch0 = FETCH_COUNTS["n"]
    p50, answers = {}, {}
    with JoinKinds() as kinds:
        for name, cases in fams.items():
            times, got = [], []
            for q, names, _want in cases:
                t0 = time.perf_counter()
                got.append(answer_tuples(sdas, q, names))
                times.append((time.perf_counter() - t0) * 1e3)
            p50[name], answers[name] = _p50(times), got
        times, got = [], []
        for q, _want in reseeds:
            t0 = time.perf_counter()
            got.append(answer_rowsets(sdas, q))
            times.append((time.perf_counter() - t0) * 1e3)
        p50["reseed"], answers["reseed"] = _p50(times), got
        t0 = time.perf_counter()
        _m, tri = lsdas.query_answer(triangle_query())
        p50["triangle_large"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    routes = dict(compiler.ROUTE_COUNTS)
    fetches = FETCH_COUNTS["n"] - fetch0
    idle = [k for k in TPU_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the mesh: {idle}")
    if not all(kinds.n[k] for k in ("index", "broadcast", "partitioned")):
        raise AssertionError(f"a join kind never ran on the mesh: {kinds.n}")
    n_queries = sum(len(c) for c in fams.values()) + len(reseeds) + 1
    if routes["host"] or routes["sharded"] != n_queries:
        raise AssertionError(f"a query left the mesh: {routes}")

    # -- correctness: numpy and the tensor store ---------------------------
    n_rows = {}
    for name, cases in fams.items():
        n_rows[name] = 0
        for (q, names, want), (matched, got) in zip(cases, answers[name]):
            if got != want or matched != bool(want):
                raise AssertionError(f"sharded {name}: an answer differs from numpy")
            if answer_tuples(das, q, names) != (matched, got):
                raise AssertionError(f"sharded {name}: an answer differs from the tensor store")
            n_rows[name] += len(got)
    for (q, want), got in zip(reseeds, answers["reseed"]):
        if got != want or got != answer_rowsets(das, q):
            raise AssertionError("sharded reseed: an answer differs from numpy")
    want_tri = HostKB(ldata, lgenes).triangle_count()
    if len(tri.assignments) != want_tri:
        raise AssertionError(f"sharded LARGE triangle {len(tri.assignments)} != numpy {want_tri}")

    # -- one query_many batch through the sharded halves (the main path's
    # runs of the same queries cached them: cleared first), then from the
    # cache
    batch = [q for q, _n, _w in fams["grounded"] + fams["not"]]
    get_sharded_executor(db).results.clear()
    reset_launch_counts()
    f0 = FETCH_COUNTS["n"]
    t0 = time.perf_counter()
    outs = sdas.query_many(batch)
    batch_ms = (time.perf_counter() - t0) * 1e3
    batch_fetches = FETCH_COUNTS["n"] - f0
    batch_launches = dict(LAUNCH_COUNTS)
    if not batch_fetches or not batch_launches["probe"]:
        raise AssertionError("sharded query_many did not run the card")
    for out, (q, _n, want) in zip(outs, fams["grounded"] + fams["not"]):
        if parse_answer(sdas, out) != {frozenset({("V2", a), ("V3", b)}) for a, b in want}:
            raise AssertionError("sharded query_many: an answer differs from numpy")
    hits0 = result_cache_stats(db)["hits"]
    reset_launch_counts()
    f0 = FETCH_COUNTS["n"]
    t0 = time.perf_counter()
    again = sdas.query_many(batch)
    cached_ms = (time.perf_counter() - t0) * 1e3
    if again != outs or FETCH_COUNTS["n"] != f0 or any(LAUNCH_COUNTS.values()):
        raise AssertionError("sharded query_many from the cache ran the card")
    cache_hits = result_cache_stats(db)["hits"] - hits0
    for k in TPU_KERNELS:
        launches[k] += batch_launches[k]

    # -- the tree families and the animals Similarity links -----------------
    row = db.fin.row_of_hex.__getitem__
    tfams = tree_families(host, sdas, sdata, sgenes, args.seed, width=8)
    tree_lines = {}
    for name in ("or2", "or_not", "and_or", "unordered"):
        compiler.reset_route_counts()
        reset_launch_counts()
        times = []
        for q, want, negation in tfams[name]:
            t0 = time.perf_counter()
            matched, neg, got = tree_answer(sdas, q, row)
            times.append((time.perf_counter() - t0) * 1e3)
            if got != want or neg != negation or matched != bool(want or negation):
                raise AssertionError(f"sharded tree {name}: an answer differs from numpy")
        r = dict(compiler.ROUTE_COUNTS)
        if r["host"] or r["sharded"] != len(tfams[name]):
            raise AssertionError(f"sharded tree {name} left the mesh: {r}")
        if name in ("or2", "or_not") and r["sharded_tree_fused"] != len(tfams[name]):
            raise AssertionError(f"sharded tree {name}: not the whole-tree mesh job: {r}")
        for k in TPU_KERNELS:
            launches[k] += LAUNCH_COUNTS[k]
        tree_lines[name] = {"p50_ms": _p50(times), "routes": {k: v for k, v in r.items() if v}}
    adas = DistributedAtomSpace(backend="sharded", device=DEVICE, config=mesh_cfg())
    adas.load_metta_text(animals_metta())
    amem = DistributedAtomSpace(backend="memory", data=load_metta_text(animals_metta()))
    reset_launch_counts()
    for q in animal_queries():
        if (tree_answer(adas, q, lambda h: h) != tree_answer(amem, q, lambda h: h)):
            raise AssertionError("sharded animals: an answer differs from the host algebra")
    for k in TPU_KERNELS:
        launches[k] += LAUNCH_COUNTS[k]

    # -- one gene commit: incremental, its slabs against a re-partition -----
    rng = random.Random(args.seed + 23)
    ref = CommitRef(host)
    name_of = {h: data.nodes[h].name for h in genes}
    procs = sorted({ref.hexes[p] for p in host.member[:, 1].tolist()})
    name_of.update((p, data.nodes[p].name) for p in procs)
    with_procs = sorted({ref.hexes[g] for g in host.member[:, 0].tolist()})
    nodes, links, new, _partners = gene_commit(rng, ref, name_of, "GENE:shard", 256, with_procs,
                                               procs)
    ref.record(db, links)
    total, version, tables = db._delta_total, db.delta_version, db.tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdas.commit_transaction(transaction(sdas, nodes, links))
    torch.cuda.synchronize()
    commit_ms = (time.perf_counter() - t0) * 1e3
    atoms = len(new) * 7
    if (db._delta_total != total + atoms or db.delta_version != version + 1
            or db.tables is not tables):
        raise AssertionError("the sharded commit was not incremental")
    for b in db.tables.buckets.values():
        check_slab_indexes(b)
    # a re-partition of a fresh finalize of the committed records (its row
    # ids differ from the live store's interned ones, its handles do not)
    t0 = time.perf_counter()
    fresh = sdata.finalize()
    rebuilt = ShardedTables(fresh, db.mesh)
    rebuild_s = time.perf_counter() - t0
    want_rows, got_rows = slab_rows(fresh, rebuilt), slab_rows(db.fin, db.tables)
    if want_rows.keys() != got_rows.keys() or not all(
            np.array_equal(want_rows[k], got_rows[k]) for k in want_rows):
        raise AssertionError("the committed slabs differ from a re-partition")
    del rebuilt, fresh
    reset_launch_counts()
    for g in [sdas.db.get_node_handle("Gene", n) for n in new[:16]]:
        for negate in (False, True):
            if answer_handles(sdas, grounded_query(sdas.data.nodes[g].name, negate)) != \
                    ref.grounded(g, negate):
                raise AssertionError("sharded post-commit answer differs from numpy")
    for k in TPU_KERNELS:
        launches[k] += LAUNCH_COUNTS[k]

    # -- on SMALL: snapshot and restore, every slab bit-equal ---------------
    small_data, small_genes = build_kb(SMALL, args.seed)
    small = DistributedAtomSpace(backend="sharded", data=small_data, device=DEVICE,
                                 config=mesh_cfg())
    snames = [small_data.nodes[h].name for h in small_genes[:8]]
    squeries = [grounded_query(g, negate) for g in snames for negate in (False, True)]
    want = [answer_handles(small, q) for q in squeries]
    root = tempfile.mkdtemp(prefix="das_sharded_")
    try:
        small.save_snapshot(root)
        back = DistributedAtomSpace(backend="sharded", device=DEVICE, config=mesh_cfg())
        back.restore_snapshot(root)
        if not back.db.tables.restored:
            raise AssertionError("SMALL sharded restore re-partitioned")
        n_arrays = 0
        for arity, b in small.db.tables.buckets.items():
            got = back.db.tables.buckets[arity].host()
            for key, arr in b.host().items():
                if not np.array_equal(got[key], arr):
                    raise AssertionError(f"SMALL sharded restore: slab {arity}/{key} differs")
                n_arrays += 1
        if [answer_handles(back, q) for q in squeries] != want:
            raise AssertionError("SMALL sharded restore: answers differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    per_slab = db.tables.nbytes_per_slab()
    emit({
        "phase": "sharded", "card": smi, "shards": SHARDS, "scale": args.scale,
        "build_s": build_s, "partition_upload_s": partition_upload_s,
        "store_bytes_allocated": store_bytes, "slab_bytes": per_slab,
        "slab_bytes_total": sum(per_slab),
        "p50_ms": p50, "tensor_p50_ms": tensor_p50, "answer_rows": n_rows,
        "triangle_large_count": len(tri.assignments), "join_kinds": kinds.n,
        "routes": {k: v for k, v in routes.items() if v}, "host_fetches": fetches,
        "query_many": {"queries": len(batch), "ms": batch_ms, "host_fetches": batch_fetches,
                       "cached_ms": cached_ms, "cache_hits": cache_hits},
        "tree": tree_lines,
        "commit": {"atoms": atoms, "commit_ms": commit_ms, "repartition_s": rebuild_s},
        "small_restore_arrays": n_arrays,
        "launches": {k: launches[k] for k in TPU_KERNELS},
        "phase_s": time.perf_counter() - t_phase,
    })
    # the launches, and what phase multiprocess prints beside its own
    return {**{k: launches[k] for k in TPU_KERNELS}, "p50_ms": p50,
            "partition_upload_s": partition_upload_s}


# ---- phase multiprocess ------------------------------------------------------------

#: shards of the cross-process mesh: 2 processes of 2 slabs each on cuda:0
MP_PROCESSES, MP_LOCAL = 2, 2
#: phase ontology's KB is this fraction of phase kb's counts, and runs
#: this many rounds of QUERY_3 (the reference benchmark runs 10): at phase
#: kb's counts a QUERY_3 round is ~12,000 queries (2,400 CoA concepts),
#: 44 s on the tensor store and 107 s on 8 slabs, and the whole smoke would
#: pass its time limit
ONTOLOGY_SCALE = 0.1
Q3_ROUNDS = 3
#: the query builders phase multiprocess names in its spec file
MP_BUILDERS = {"grounded_query": grounded_query, "grounded_star_query": grounded_star_query,
               "fanout_star_query": fanout_star_query,
               "template_join_query": template_join_query}


def multiprocess_cases(args, data, host):
    """The count-only queries of phase multiprocess, as (family, query
    builder name, builder arguments), with numpy's count of each: grounded
    and Not 3-clause queries on genes whose answers are both non-empty,
    grounded and fan-out stars, and template joins (which hash-partition)."""
    name_of_row = lambda r: data.nodes[host.fin.hex_of_row[r]].name  # noqa: E731
    rng = random.Random(args.seed + 31)
    rows = host.nonempty_genes().tolist()
    rng.shuffle(rows)
    picked = []
    for r in rows:
        if len(picked) == 8:
            break
        if host.grounded(r, True):
            picked.append(r)
    stars, fan = star_rows(args, host)
    cases = []
    for r in picked:
        cases.append(("grounded", "grounded_query", [name_of_row(r), False],
                      len(host.grounded(r, False))))
        cases.append(("not", "grounded_query", [name_of_row(r), True],
                      len(host.grounded(r, True))))
    for g, p1, p2 in stars[:8]:
        cases.append(("grounded_star", "grounded_star_query",
                      [name_of_row(g), name_of_row(p1), name_of_row(p2)],
                      len(host.grounded_star(g, p1, p2))))
    for p in fan[:4]:
        cases.append(("fanout_star", "fanout_star_query", [name_of_row(p)],
                      len(host.fanout_star(p))))
    for r in picked[:4]:
        cases.append(("template_join", "template_join_query", [name_of_row(r)],
                      len({(x, y) for x in set(host.partners(r).tolist())
                           for y in set(host.partners(x).tolist())})))
    return cases


def multiprocess_child(args) -> int:
    """One rank of phase multiprocess (chip_smoke.py --multiprocess-child R):
    joins the gloo group, builds phase kb's configuration and seed, deals it
    over the 4-shard mesh with only its own 2 slabs uploaded to cuda:0, and
    counts every case of the spec file through the sharded executor.
    Prints one RESULT line: per case the stats vector and count, the
    partition and upload seconds, per family the p50, the kernels launched
    and each collective's calls, wall and host-staging seconds."""
    import torch

    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.parallel import mesh as M
    from das_tpu_torch.parallel.fused_sharded import get_sharded_executor
    from das_tpu_torch.parallel.sharded_db import ShardedDB
    from das_tpu_torch.query import compiler, fused

    rank = args.multiprocess_child
    with open(args.spec) as f:
        cases = json.load(f)
    M.multihost_initialize(args.coordinator, num_processes=MP_PROCESSES, process_id=rank,
                           timeout_s=600)
    try:
        t0 = time.perf_counter()
        data, _genes = build_kb(scaled(FLYBASE, args.scale), args.seed)
        build_s = time.perf_counter() - t0
        mesh = M.make_mesh(MP_PROCESSES * MP_LOCAL, device=DEVICE + ":0")
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        db = ShardedDB(data, DasConfig(), mesh=mesh)
        torch.cuda.synchronize()
        partition_upload_s = time.perf_counter() - t0
        store_bytes = torch.cuda.memory_allocated() - mem0
        ex = get_sharded_executor(db)
        queries = [MP_BUILDERS[b](*a) for _fam, b, a, _n in cases]
        M.reset_collective_stats()
        reset_launch_counts()
        out, times = [], {}
        with JoinKinds() as kinds:
            for (fam, _b, _a, _n), q in zip(cases, queries):
                t0 = time.perf_counter()
                job = ex._exec_job(compiler.plan_query(db, q), True)
                while True:
                    dev = job.dispatch()
                    host = fused.fetch(*dev)
                    if job.settle(host, dev):
                        break
                times.setdefault(fam, []).append((time.perf_counter() - t0) * 1e3)
                out.append({"stats": [int(x) for x in host[0]], "count": job.result.count,
                            "reseed": job.result.reseed_needed, "rounds": job.rounds})
        torch.cuda.synchronize()
        print("RESULT " + json.dumps({
            "rank": rank, "local_shards": list(mesh.local_shards), "build_s": build_s,
            "partition_upload_s": partition_upload_s, "store_bytes_allocated": store_bytes,
            "slab_bytes": db.tables.nbytes_per_slab(), "cases": out,
            "p50_ms": {k: _p50(v) for k, v in times.items()}, "join_kinds": kinds.n,
            "launches": {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS},
            "collectives": M.COLLECTIVE_STATS}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_multiprocess(args, das, data, host, sharded, smi, meanwhile=None):
    """The mesh across processes: two child processes of this script
    (--multiprocess-child), gloo on 127.0.0.1, 2 slabs each on cuda:0 (S =
    4), each building the KB of phase kb from the same seed and uploading
    its own slabs; count-only grounded, Not, grounded-star, fan-out-star
    and template-join queries (hash-partitioned, so all_to_all crosses the
    processes).  Every count equals numpy's and the tensor store's, both
    ranks' stats vectors are equal, and all five kernels launched in each
    child.  A child that fails or outlives its time fails the phase.
    While the children build, this process counts on the tensor store and
    then calls `meanwhile()` (host work of a later phase), whose result it
    returns beside the launches."""
    import shutil
    import socket
    import tempfile

    from das_tpu_torch.query import compiler

    t_phase = time.perf_counter()
    cases = multiprocess_cases(args, data, host)
    root = tempfile.mkdtemp(prefix="das_multiprocess_")
    procs, logs = [], []
    try:
        spec = os.path.join(root, "cases.json")
        with open(spec, "w") as f:
            json.dump(cases, f)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for rank in range(MP_PROCESSES):
            log = open(os.path.join(root, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multiprocess-child", str(rank),
                 "--coordinator", f"127.0.0.1:{port}", "--spec", spec,
                 "--scale", str(args.scale), "--seed", str(args.seed)],
                stdout=log, stderr=subprocess.STDOUT, text=True))
        deadline = time.perf_counter() + 600
        tensor_counts = [compiler.count_matches(das.db, MP_BUILDERS[b](*a))
                         for _f, b, a, _n in cases]
        during = meanwhile() if meanwhile is not None else None
        wait_s = time.perf_counter()
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        results = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"multiprocess rank {rank} failed (exit {p.returncode}):\n"
                                     + text[-4000:])
            results.append(json.loads(lines[-1][len("RESULT "):]))
        wait_s = time.perf_counter() - wait_s
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(root, ignore_errors=True)

    r0, r1 = results
    for i, ((fam, _b, a, want), tensor_n) in enumerate(zip(cases, tensor_counts)):
        c0, c1 = r0["cases"][i], r1["cases"][i]
        if c0["stats"] != c1["stats"]:
            raise AssertionError(f"multiprocess {fam} {a}: the ranks' stats differ")
        if c0["reseed"] or c0["count"] != want or tensor_n != want:
            raise AssertionError(f"multiprocess {fam} {a}: count {c0['count']} (reseed "
                                 f"{c0['reseed']}), tensor {tensor_n}, numpy {want}")
    for r in results:
        idle = [k for k in TPU_KERNELS if r["launches"][k] == 0]
        if idle:
            raise AssertionError(f"rank {r['rank']}: kernels never launched: {idle}")
        if not r["join_kinds"]["partitioned"]:
            raise AssertionError(f"rank {r['rank']}: no hash-partitioned join ran")
        if [r["local_shards"]] != [[MP_LOCAL * r["rank"] + i for i in range(MP_LOCAL)]]:
            raise AssertionError(f"rank {r['rank']} holds shards {r['local_shards']}")
    staging = {
        r["rank"]: {k: {"calls": v["calls"], "wall_s": v["wall_s"],
                        "staging_share": (v["staging_s"] / v["wall_s"]) if v["wall_s"] else None}
                    for k, v in r["collectives"].items()}
        for r in results}
    emit({"phase": "multiprocess", "card": smi, "processes": MP_PROCESSES,
          "slabs_per_process": MP_LOCAL, "backend": "gloo", "scale": args.scale,
          "cases": len(cases),
          "counts": {fam: [c["count"] for (f, _b, _a, _n), c in zip(cases, r0["cases"])
                           if f == fam] for fam in dict.fromkeys(c[0] for c in cases)},
          "build_s": [r["build_s"] for r in results],
          "partition_upload_s": [r["partition_upload_s"] for r in results],
          "sharded_partition_upload_s": sharded.get("partition_upload_s"),
          "slab_bytes": [r["slab_bytes"] for r in results],
          "store_bytes_allocated": [r["store_bytes_allocated"] for r in results],
          "p50_ms": [r["p50_ms"] for r in results], "sharded_p50_ms": sharded.get("p50_ms"),
          "rounds": [c["rounds"] for c in r0["cases"]], "join_kinds": r0["join_kinds"],
          "collectives": staging, "launches": [r["launches"] for r in results],
          "children_wait_s": wait_s, "phase_s": time.perf_counter() - t_phase})
    return {k: sum(r["launches"][k] for r in results) for k in TPU_KERNELS}, during


# ---- phase ontology ----------------------------------------------------------------


def same_biological_process(gene_names):
    """QUERY_1 of the reference benchmark: an N-way And of grounded Member
    links sharing one process."""
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    v1 = Variable("V_BiologicalProcess")
    return And([Link("Member", [Node("Gene", g), v1], True) for g in gene_names])


def same_or_inherited_biological_process(gene_names):
    """QUERY_2 of the reference benchmark: a nested And/Or with
    Inheritance LinkTemplates."""
    from das_tpu_torch.query.ast import And, Link, LinkTemplate, Node, Or, TypedVariable, Variable

    v1, v2 = Variable("V1_BiologicalProcess"), Variable("V2_BiologicalProcess")
    tv1 = TypedVariable("V1_BiologicalProcess", "BiologicalProcess")
    tv2 = TypedVariable("V2_BiologicalProcess", "BiologicalProcess")
    tv3 = TypedVariable("V3_BiologicalProcess", "BiologicalProcess")
    g1, g2 = gene_names[0], gene_names[1]
    return And([
        Link("Member", [Node("Gene", g1), v1], True),
        Or([And([Link("Member", [Node("Gene", g2), v2], True),
                 LinkTemplate("Inheritance", [tv2, tv3], True),
                 LinkTemplate("Inheritance", [tv1, tv3], True)]),
            Link("Member", [Node("Gene", g2), v1], True)]),
    ])


def _dispatch(das, query):
    from das_tpu_torch.query.ast import PatternMatchingAnswer

    answer = PatternMatchingAnswer()
    matched = das._dispatch_query(query, answer)
    return bool(matched), {frozenset(a.mapping.items()) for a in answer.assignments}


def coa_pipeline(das, gene_names, db, concepts=None):
    """QUERY_3 of the reference benchmark through `das`: the Concepts whose
    name holds "CoA" (the first `concepts` of them, in handle order, when
    given), their Reactomes through List, those Reactomes' Uniprots
    through Member, then each Uniprot's processes shared with every gene.
    Node names are read from `db`.  Returns (matched, every stage's
    answer)."""
    from das_tpu_torch.query.ast import And, Link, Node, Variable

    v1 = Variable("v1")
    members = [Link("Member", [Node("Gene", g), v1], True) for g in gene_names]
    handles = sorted(db.get_matched_node_name("Concept", "CoA"))
    if concepts is not None:
        handles = handles[:concepts]
    stages, reactomes, uniprots = [], [], []
    for h in handles:
        ok, got = _dispatch(das, Link("List", [v1, Node("Concept", db.get_node_name(h))], True))
        stages.append(got)
        reactomes += sorted(dict(a)["v1"] for a in got) if ok else []
    for r in reactomes:
        ok, got = _dispatch(das, Link("Member", [v1, Node("Reactome", db.get_node_name(r))],
                                      True))
        stages.append(got)
        uniprots += sorted(dict(a)["v1"] for a in got) if ok else []
    matched = False
    for u in uniprots:
        ok, got = _dispatch(das, And([*members, Link(
            "Member", [Node("Uniprot", db.get_node_name(u)), v1], True)]))
        stages.append(got)
        matched = matched or ok
    return matched, stages


def ontology_kb(args):
    """build_bio_ontology_atomspace at ONTOLOGY_SCALE of phase kb's gene,
    process and interaction counts, its Reactomes and Uniprots scaled from
    their defaults by the same factor as the genes: (config, data, genes,
    build seconds)."""
    from das_tpu_torch.models.bio import build_bio_ontology_atomspace

    cfg = scaled(FLYBASE, args.scale * ONTOLOGY_SCALE)
    factor = cfg["n_genes"] / 1000          # the generator's default gene count
    onto = dict(n_genes=cfg["n_genes"], n_processes=cfg["n_processes"],
                members_per_gene=cfg["members_per_gene"], n_interactions=cfg["n_interactions"],
                n_reactomes=max(1, int(100 * factor)), n_uniprots=max(1, int(300 * factor)))
    t0 = time.perf_counter()
    data, genes, _procs = build_bio_ontology_atomspace(seed=args.seed, **onto)
    return onto, data, genes, time.perf_counter() - t0


def phase_ontology(args, smi, kb=None):
    """The reference benchmark's three query layouts on the ontology KB
    (`ontology_kb`, or `kb` when it was built already): QUERY_1 and QUERY_2
    with 2 sampled genes, 100 rounds each, and QUERY_3 (Q3_ROUNDS
    rounds), on the tensor store and on an 8-slab sharded store on the
    card; p50, matched counts, routes and launches per store.  The two
    stores' answers are equal on every round; on a sample (2 QUERY_1 pairs,
    one of them sharing a process, a QUERY_2 pair sharing a process, and
    QUERY_3's pipeline from one CoA concept) they equal the host algebra's
    (the memory backend)."""
    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.ast import Link, Node, Variable

    t_phase = time.perf_counter()
    onto, data, genes, build_s = kb if kb is not None else ontology_kb(args)
    t0 = time.perf_counter()
    stores = {"tensor": DistributedAtomSpace(backend="tensor", data=data, device=DEVICE)}
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stores["sharded"] = DistributedAtomSpace(backend="sharded", data=data, device=DEVICE,
                                             config=DasConfig(mesh_shape=(SHARDS,)))
    torch.cuda.synchronize()
    partition_upload_s = time.perf_counter() - t0
    host = DistributedAtomSpace(backend="memory", data=data)
    db = host.db
    names = [data.nodes[h].name for h in genes]
    rng = random.Random(args.seed + 7)
    rounds = {1: [rng.sample(names, 2) for _ in range(100)],
              2: [rng.sample(names, 2) for _ in range(100)],
              3: [rng.sample(names, 2) for _ in range(Q3_ROUNDS)]}
    builders = {1: same_biological_process, 2: same_or_inherited_biological_process}
    out, answers = {}, {}
    for store, das in stores.items():
        torch.cuda.synchronize()
        compiler.reset_route_counts()
        reset_launch_counts()
        line, got = {}, {}
        for layout in (1, 2):
            times, got[layout] = [], []
            for sample in rounds[layout]:
                q = builders[layout](sample)
                t0 = time.perf_counter()
                got[layout].append(_dispatch(das, q))
                times.append((time.perf_counter() - t0) * 1e3)
            line[f"query{layout}"] = {"rounds": len(times), "p50_ms": _p50(times),
                                      "matched": sum(ok for ok, _a in got[layout]),
                                      "answers": sum(len(a) for _ok, a in got[layout])}
        times, got[3] = [], []
        for sample in rounds[3]:
            t0 = time.perf_counter()
            got[3].append(coa_pipeline(das, sample, db))
            times.append((time.perf_counter() - t0) * 1e3)
        line["query3"] = {"rounds": len(times), "p50_ms": _p50(times),
                          "matched": sum(ok for ok, _st in got[3]),
                          "queries_per_round": len(got[3][0][1])}
        torch.cuda.synchronize()
        line["routes"] = {k: v for k, v in compiler.ROUTE_COUNTS.items() if v}
        line["launches"] = {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS}
        if compiler.ROUTE_COUNTS["host"]:
            raise AssertionError(f"ontology on {store}: a query left the card: {line['routes']}")
        out[store], answers[store] = line, got
    for layout in (1, 2, 3):
        if answers["tensor"][layout] != answers["sharded"][layout]:
            raise AssertionError(f"ontology: QUERY_{layout}'s answers differ between the stores")

    # the host algebra on a sample (one host query takes seconds here): a
    # timed QUERY_1 pair, and a QUERY_1 and a QUERY_2 pair that share a
    # process, found through the tensor store, so that an answer is not
    # empty (two random genes rarely share one at this size)
    v = Variable("V")
    gene_set = set(names)
    shared = None
    for g1 in rng.sample(names, 64):
        _ok, procs = _dispatch(stores["tensor"], Link("Member", [Node("Gene", g1), v], True))
        for p in sorted(dict(a)["V"] for a in procs):
            _ok, members = _dispatch(stores["tensor"], Link(
                "Member", [v, Node("BiologicalProcess", db.get_node_name(p))], True))
            others = sorted(n for n in (db.get_node_name(dict(a)["V"]) for a in members)
                            if n != g1 and n in gene_set)
            if others:
                shared = [g1, others[0]]
                break
        if shared is not None:
            break
    checks = [(1, rounds[1][0]), (1, shared), (2, shared)]
    t0 = time.perf_counter()
    host_matched = 0
    for layout, sample in checks:
        q = builders[layout](sample)
        want = _dispatch(host, q)
        host_matched += want[0]
        for store, das in stores.items():
            if _dispatch(das, q) != want:
                raise AssertionError(f"ontology on {store}: QUERY_{layout} {sample} differs "
                                     "from the host algebra")
    want = coa_pipeline(host, rounds[3][0], db, concepts=1)
    for store, das in stores.items():
        if coa_pipeline(das, rounds[3][0], db, concepts=1) != want:
            raise AssertionError(f"ontology on {store}: QUERY_3 differs from the host algebra")
    host_check_s = time.perf_counter() - t0
    idle = [k for k in TPU_KERNELS if not any(out[s]["launches"][k] for s in out)]
    emit({"phase": "ontology", "card": smi, "config": onto, "scale": args.scale,
          "nodes": len(data.nodes), "links": len(data.links), "build_s": build_s,
          "upload_s": upload_s, "partition_upload_s": partition_upload_s,
          "shards": SHARDS, "stores": out, "kernels_never_launched": idle,
          "host_checks": {"query1": 2, "query2": 1, "query3_concepts": 1,
                          "query3_stages": len(want[1]), "matched": host_matched,
                          "s": host_check_s},
          "phase_s": time.perf_counter() - t_phase})
    launches = {k: sum(out[s]["launches"][k] for s in out) for k in TPU_KERNELS}
    del stores
    torch.cuda.empty_cache()
    return launches


# ---- phase programs ----------------------------------------------------------------

#: the sites with a byte model (the exact program has none, as in das_tpu)
MODELED_SITES = ("fused", "fused_tree", "count_batch", "sharded", "sharded_tree")
#: a CUDA kernel's name prefix in csrc/, per kernel
KERNEL_PREFIX = {"probe": "pr_", "index_join": "ij_", "join_tables": "jt_", "anti_join": "aj_",
                 "multiway": "mw_"}


def program_workload(das, sdas, families, picks, lpicks):
    """The slice's and the tree's families on the tensor store (grounded,
    Not, grounded stars, Ors of two chains), a count group of the grounded
    queries, and grounded, Not and Or queries on an 8-slab store, with
    every result cache cleared first."""
    from das_tpu_torch.parallel.fused_sharded import get_sharded_executor
    from das_tpu_torch.query import compiler, fused

    for ex in (fused.get_executor(das.db), get_sharded_executor(sdas.db)):
        ex.results.clear()
        ex.tree_results.clear()
    for q, _n, _w in families["grounded"][:8]:
        das.query_answer(q)
    for g in picks:
        das.query_answer(grounded_query(g, True))
    for q, _n, _w in families["grounded_star"][:8]:
        das.query_answer(q)
    for a, b in zip(picks[:4], picks[4:8]):
        das.query_answer(or_query(a, b))
    fused.get_executor(das.db).count_batch(
        [compiler.plan_query(das.db, grounded_query(g)) for g in picks])
    for a, b in zip(lpicks[:4], lpicks[4:8]):
        sdas.query_answer(grounded_query(a))
        sdas.query_answer(grounded_query(a, True))
        sdas.query_answer(or_query(a, b))


def or_query(g1, g2):
    """Or of two grounded chains Member(g, $V3) and Member($V2, $V3) (one
    whole-tree job)."""
    from das_tpu_torch.query.ast import And, Link, Node, Or, Variable

    return Or([And([Link("Member", [Node("Gene", g), Variable("V3")], True),
                    Link("Member", [Variable("V2"), Variable("V3")], True)]) for g in (g1, g2)])


def phase_programs(args, das, data, genes, host, families, large, smi):
    """The program ledger on the card (obs/proflog.py): the cold start (the
    kernel library's nvcc build and the scanner's g++ build into empty
    directories, then loads of what they built), the slice's and the
    tree's families, a count group and an 8-slab store's families run once
    cold (first calls: "compiles") and once warm (ledger hits), the
    ledger's snapshot after each, and every modeled site's
    budget_vs_actual on the card.  Then, with obs annotations on and
    DasConfig.profiler_trace_dir set, a torch.profiler trace of a grounded,
    a Not and a grounded-star query, which must hold exec.dispatch and the
    five kernels."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from das_tpu_torch import obs
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.ingest import native
    from das_tpu_torch.kernels import LAUNCH_COUNTS, launch, reset_launch_counts
    from das_tpu_torch.obs import proflog, torchprof
    from das_tpu_torch.query import fused

    t_phase = time.perf_counter()
    ldas, ldata, lgenes = large
    sdas = DistributedAtomSpace(backend="sharded", data=ldata, device=DEVICE,
                                config=DasConfig(mesh_shape=(SHARDS,)))
    gene_names = [data.nodes[h].name for h in genes]
    picks = pick_genes(host, gene_names, args.seed + 41, n=8, n_nonempty=8)
    lpicks = pick_genes(HostKB(ldata, lgenes), [ldata.nodes[h].name for h in lgenes],
                        args.seed + 41, n=8, n_nonempty=8)
    root = tempfile.mkdtemp(prefix="das_programs_")
    saved = (launch.BUILD_DIR, launch._LIB, native.BUILD_DIR, native._lib)
    proflog.configure(enabled=True)
    proflog.reset()
    try:
        # -- the cold start: fresh builds, then loads of the built libraries
        try:
            launch.BUILD_DIR, launch._LIB = Path(root) / "kernels", None
            launch.library()
            launch._LIB = None
            launch.library()
            native.BUILD_DIR, native._lib = Path(root) / "native", None
            native.get_lib()
            native._lib = None
            native.get_lib()
        finally:
            launch.BUILD_DIR, launch._LIB, native.BUILD_DIR, native._lib = saved
        builds = {r["site"]: {"first_s": r["first_compile_s"], "compiles": r["compiles"]}
                  for r in proflog.rows() if r["kind"] == "build"}
        cold_start = proflog.snapshot()
        if set(builds) != {"kernel_build", "scanner_build"} or \
                cold_start["persistent_cache_hits"] != 2 or cold_start["cold_start_s"] <= 0:
            raise AssertionError(f"programs: the cold start was not recorded: {cold_start}")

        # -- the families, cold then warm; counters zeroed just before.  The
        # tree functions earlier phases built were built with the ledger off:
        # build them anew, so that they are instrumented
        fused.get_executor(das.db)._tree_progs.clear()
        torch.cuda.synchronize()
        reset_launch_counts()
        passes = {}
        for label in ("cold", "warm"):
            before = proflog.snapshot()
            t0 = time.perf_counter()
            program_workload(das, sdas, families, picks, lpicks)
            torch.cuda.synchronize()
            after = proflog.snapshot()
            passes[label] = {"s": time.perf_counter() - t0,
                             "compiles": after["compiles"] - before["compiles"],
                             "calls": after["calls"] - before["calls"],
                             "ledger_hits": after["ledger_hits"] - before["ledger_hits"],
                             "launch_notes": after["launches"] - before["launches"]}
        launches = dict(LAUNCH_COUNTS)
        snap = proflog.snapshot()
        missing = [s for s in MODELED_SITES if s not in snap["budget_vs_actual"]]
        if missing:
            raise AssertionError(f"programs: no budget_vs_actual for {missing}: {snap}")
        if passes["cold"]["compiles"] == 0 or passes["warm"]["ledger_hits"] == 0:
            raise AssertionError(f"programs: no first calls or no hits: {passes}")
        per_site = {}
        for r in proflog.rows():
            if r["kind"] != "eager":
                continue
            e = per_site.setdefault(r["site"], {"entries": 0, "compiles": 0, "hits": 0,
                                                "compile_s": 0.0, "peak_bytes_max": 0,
                                                "modeled_bytes_max": 0, "ratios": []})
            e["entries"] += 1
            e["compiles"] += r["compiles"]
            e["hits"] += r["hits"]
            e["compile_s"] += r["compile_s"]
            e["peak_bytes_max"] = max(e["peak_bytes_max"], r["peak_bytes"] or 0)
            e["modeled_bytes_max"] = max(e["modeled_bytes_max"], r["modeled_bytes"] or 0)
            if r["budget_vs_actual_ratio"] is not None:
                e["ratios"].append(r["budget_vs_actual_ratio"])
        for e in per_site.values():
            rs = sorted(e.pop("ratios"))
            e["ratio_min_p50_max"] = [rs[0], _p50(rs), rs[-1]] if rs else None
        kernel_notes = {}
        for r in proflog.rows(site="kernel"):
            k = kernel_notes.setdefault(r["kind"], [0, 0.0])
            k[0] += r["launches"]
            k[1] += r["trace_s"]
        if set(kernel_notes) != {"cuda"}:
            raise AssertionError(f"programs: kernel notes of kind {sorted(kernel_notes)}")

        # -- a profiler trace
        proflog.configure(enabled=False)
        obs.configure(annotations=True)
        trace_dir = os.path.join(root, "trace")
        if not obs.maybe_start_trace(DasConfig(profiler_trace_dir=trace_dir)):
            raise AssertionError("programs: the profiler trace did not start")
        das.query_answer(families["grounded"][0][0])
        das.query_answer(grounded_query(picks[0], True))
        cfg = das.db.config
        mode, cfg.use_multiway = cfg.use_multiway, "on"
        try:
            das.query_answer(families["grounded_star"][0][0])
        finally:
            cfg.use_multiway = mode
        torch.cuda.synchronize()
        obs.maybe_stop_trace()
        path = torchprof.last_trace_path()
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            # the profiler's own events: the recorder's, merged in beside
            # them, would answer for exec.dispatch with its own span
            names = {str(e.get("name", "")) for e in
                     split_merged_trace(json.load(f).get("traceEvents", []))[0]}
        in_trace = {k: sorted(n for n in names if re.search(rf"\b{p}\w*kernel", n))[:3]
                    for k, p in KERNEL_PREFIX.items()}
        absent = [k for k, v in in_trace.items() if not v]
        if "exec.dispatch" not in names or absent:
            raise AssertionError(f"programs: the trace lacks exec.dispatch or kernels {absent}")
    finally:
        proflog.reset()
        proflog.configure(enabled=False)
        obs.configure(annotations=False)
        shutil.rmtree(root, ignore_errors=True)
    del sdas
    emit({"phase": "programs", "card": smi, "builds": builds,
          "cold_start": {k: cold_start[k] for k in ("cold_start_s", "persistent_cache_hits",
                                                      "entries")},
          "passes": passes, "snapshot": snap, "sites": per_site,
          "kernel_notes": {k: {"launches": n, "wrapper_s": s}
                           for k, (n, s) in kernel_notes.items()},
          "trace": {"bytes": trace_bytes, "kernels": in_trace},
          "launches": {k: launches[k] for k in TPU_KERNELS},
          "phase_s": time.perf_counter() - t_phase})
    return {k: launches[k] for k in TPU_KERNELS}


class CommitRef:
    """The numpy reference of the commit phase, in handle space: the
    pre-commit HostKB plus the Member and Interacts pairs the phase itself
    wrote.  It never reads the store's merged tables."""

    def __init__(self, host):
        self.host = host
        self.hexes = host.fin.hex_of_row
        self.rows = host.fin.row_of_hex
        self.n_base = len(self.hexes)       # rows the HostKB arrays cover
        self.procs_x, self.members_x, self.partners_x = {}, {}, {}

    def _base(self, fn, h):
        r = self.rows.get(h)
        if r is None or r >= self.n_base:
            return []
        return [self.hexes[x] for x in fn(r).tolist()]

    def add_member(self, g, p):
        self.procs_x.setdefault(g, []).append(p)
        self.members_x.setdefault(p, []).append(g)

    def add_interacts(self, a, b):
        self.partners_x.setdefault(a, []).append(b)

    def record(self, db, links):
        """Add a commit's Member and Interacts links, given by name."""
        for link_type, a, b in links:
            ha = db.get_node_handle("Gene", a)
            if link_type == "Member":
                self.add_member(ha, db.get_node_handle("BiologicalProcess", b))
            else:
                self.add_interacts(ha, db.get_node_handle("Gene", b))

    def procs(self, g):
        return self._base(self.host.procs, g) + self.procs_x.get(g, [])

    def members(self, p):
        return self._base(self.host.members, p) + self.members_x.get(p, [])

    def partners(self, g):
        return self._base(self.host.partners, g) + self.partners_x.get(g, [])

    def grounded(self, g, negate):
        """{frozenset((variable, handle))} of grounded_query(g, negate)."""
        partners = set(self.partners(g))
        return {frozenset({("V2", v2), ("V3", p)}) for p in self.procs(g)
                for v2 in self.members(p) if (v2 in partners) != negate}

    def grounded_star(self, g, p1, p2):
        both = set(self.members(p1)) & set(self.members(p2))
        return {frozenset({("V1", v)}) for v in set(self.partners(g)) & both}


def parse_handles(s):
    """{frozenset((variable, handle))} of an answer string."""
    return {frozenset(ast.literal_eval(d).items()) for d in re.findall(r"\{[^{}]*\}", s)}


def answer_handles(das, query):
    matched, answer = das.query_answer(query)
    got = {frozenset(a.mapping.items()) for a in answer.assignments}
    return got if matched else set()


def transaction(das, nodes, links, types=()):
    """A Transaction of `links` [(type, target names...)]: new link `types`
    declared, then every node it names declared with its type ({name:
    type}), since `build_bio_atomspace` adds its nodes without declarations; a
    declaration adds no atom."""
    tx = das.open_transaction()
    for t in types:
        tx.add(f"(: {t} Type)")
    for n, t in nodes.items():
        tx.add(f'(: "{n}" {t})')
    for link_type, *names in links:
        tx.add(f"({link_type} " + " ".join(f'"{n}"' for n in names) + ")")
    return tx


def gene_commit(rng, ref, name_of, prefix, n_new, existing, procs, partners_first=()):
    """(nodes, links, new gene names, partner handles) of a commit of n_new
    new genes, each a Member of 4 of the existing `procs` and Interacts with
    one of the `existing` genes in both orientations: 7 atoms a gene.  The first process
    of each new gene is one of its partner's, so its grounded answer is
    non-empty; the partners of the first new genes are `partners_first`."""
    nodes, links, new, partners = {}, [], [], []
    for i in range(n_new):
        n = f"{prefix}{i:04d}"
        x = partners_first[i] if i < len(partners_first) else rng.choice(existing)
        mine = [ref.procs(x)[0]]
        while len(mine) < 4:
            p = rng.choice(procs)
            if p not in mine:
                mine.append(p)
        nodes[n] = "Gene"
        nodes[name_of[x]] = "Gene"
        for p in mine:
            nodes[name_of[p]] = "BiologicalProcess"
            links.append(("Member", n, name_of[p]))
        links += [("Interacts", n, name_of[x]), ("Interacts", name_of[x], n)]
        new.append(n)
        partners.append(x)
    return nodes, links, new, partners


def check_merged_bucket(b):
    """Structural checks of every sorted key column of a merged bucket:
    keys non-decreasing over [:size] and the dtype's max after it, perm a
    permutation of the rows, each key the key of the row perm points to."""
    import torch

    n = b.size
    tid = b.type_id.long()
    cols = [("key_type", b.key_type, b.order_by_type, lambda r: b.type_id[r]),
            ("key_ctype", b.key_ctype, b.order_by_ctype, lambda r: b.ctype[r])]
    for p in range(b.arity):
        cols += [
            (f"key_type_pos[{p}]", b.key_type_pos[p], b.order_by_type_pos[p],
             lambda r, p=p: (tid[r] << 32) | b.targets[r, p].long()),
            (f"key_pos[{p}]", b.key_pos[p], b.order_by_pos[p], lambda r, p=p: b.targets[r, p]),
            (f"key_type_spos[{p}]", b.key_type_spos[p], b.order_by_type_spos[p],
             lambda r, p=p: (tid[r] << 32) | b.targets_sorted[r, p].long()),
        ]
    for name, keys, perm, derive in cols:
        k = keys[:n]
        if n > 1 and not bool((k[1:] >= k[:-1]).all()):
            raise AssertionError(f"{name}: keys decrease")
        if not bool((keys[n:] == torch.iinfo(keys.dtype).max).all()):
            raise AssertionError(f"{name}: a slot after size is not the dtype's max")
        r = perm[:n].long()
        if not torch.equal(torch.sort(r).values, torch.arange(n, device=r.device)):
            raise AssertionError(f"{name}: perm is not a permutation of the rows")
        if not torch.equal(derive(r).to(keys.dtype), k):
            raise AssertionError(f"{name}: a key is not the key of its row")
    return len(cols)


def phase_commit(args, das, data, genes, host, smi, upload_s, slice_p50):
    """Incremental commits through open_transaction / commit_transaction on
    the slice's store (after the reads: it changes the store), then growth,
    a new arity and a threshold rebuild on SMALL.  Counters zeroed just before,
    read just after."""
    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler
    from das_tpu_torch.query.fused import result_cache_stats
    from das_tpu_torch.storage import tensor_db

    t_phase = time.perf_counter()
    rng = random.Random(args.seed + 7)
    db = das.db
    ref = CommitRef(host)
    name_of = {h: data.nodes[h].name for h in genes}
    procs = sorted({ref.hexes[p] for p in host.member[:, 1].tolist()})
    name_of.update((p, data.nodes[p].name) for p in procs)
    with_procs = sorted({ref.hexes[g] for g in host.member[:, 0].tolist()})
    gene_names = [data.nodes[h].name for h in genes]
    chosen = pick_genes(host, gene_names, args.seed)
    chosen_h = [db.get_node_handle("Gene", g) for g in chosen]
    batch = [grounded_query(g) for g in chosen] + [grounded_query(g, True) for g in chosen]
    dup = list(range(4)) + list(range(32, 36))
    batch += [batch[i] for i in dup]
    keys = [(h, False) for h in chosen_h] + [(h, True) for h in chosen_h]
    keys += [keys[i] for i in dup]

    # the device merge, timed by CUDA events around each arity's staging
    merges = []
    stage = db._stage_delta_merge

    def timed_stage(delta):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = stage(delta)
        end.record()
        merges[-1].append((start, end))
        return out

    db._stage_delta_merge = timed_stage
    cap2, nbytes = db.dev.buckets[2].capacity, db.dev.nbytes()
    commit_ms, merge_ms, per_commit = [], [], []
    times = {"grounded": [], "not": []}
    checked = 0

    def commit(tx, atoms):
        total, version = db._delta_total, db.delta_version
        merges.append([])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        das.commit_transaction(tx)
        torch.cuda.synchronize()
        commit_ms.append((time.perf_counter() - t0) * 1e3)
        merge_ms.append(sum(s.elapsed_time(e) for s, e in merges[-1]))
        if db._delta_total != total + atoms or db.delta_version != version + 1:
            raise AssertionError(f"commit of {atoms} atoms: _delta_total {total} -> "
                                 f"{db._delta_total}, delta_version {version} -> "
                                 f"{db.delta_version} (a rebuild ran?)")
        if das.db is not db or db.dev.buckets[2].capacity != cap2 or db.dev.nbytes() != nbytes:
            raise AssertionError("a commit grew or replaced the store")
        per_commit.append({"atoms": atoms, "commit_ms": commit_ms[-1],
                           "merge_ms": merge_ms[-1]})

    def check_answers(gene_hexes):
        nonlocal checked
        for negate, kind in ((False, "grounded"), (True, "not")):
            for g in gene_hexes:
                q = grounded_query(name_of_any(g), negate)
                t0 = time.perf_counter()
                got = answer_handles(das, q)
                times[kind].append((time.perf_counter() - t0) * 1e3)
                if got != ref.grounded(g, negate):
                    raise AssertionError(f"post-commit {kind} answer of {name_of_any(g)} "
                                         f"differs from numpy")
                checked += 1

    def name_of_any(h):
        return name_of.get(h) or das.data.nodes[h].name

    def check_star(g, x):
        p1, p2 = sorted(ref.procs(x))[:2]
        q = grounded_star_query(name_of_any(g), name_of[p1], name_of[p2])
        r0 = compiler.ROUTE_COUNTS["fused_multiway"]
        got = answer_handles(das, q)
        routed = compiler.ROUTE_COUNTS["fused_multiway"] - r0
        if not routed:
            cfg = db.config
            mode, cfg.use_multiway = cfg.use_multiway, "on"
            try:
                got = answer_handles(das, q)
            finally:
                cfg.use_multiway = mode
            if compiler.ROUTE_COUNTS["fused_multiway"] == r0:
                raise AssertionError("the post-commit star took no multiway step")
        if not got or got != ref.grounded_star(g, p1, p2):
            raise AssertionError("the post-commit grounded star differs from numpy")
        return bool(routed)

    from das_tpu_torch.query.ast import Link, Node, Or, Variable
    from das_tpu_torch.storage.memory_db import MemoryDB

    def tree_want(g, other):
        """CommitRef's answer of tree_qs' query on (g, other)."""
        chain = {frozenset({("V2", m), ("V3", p)}) for p in ref.procs(g)
                 for m in ref.members(p)}
        if other is None:
            return chain | {frozenset({("V5", x)}) for x in ref.partners(g)}
        return chain | {frozenset({("V2", m), ("V3", p)}) for p in ref.procs(other)
                        for m in ref.members(p)}

    # tree queries on the first chosen gene, whose answers the first commit
    # changes: a whole-tree job and a staged tree, cached before the commit
    tree_qs = [(Or([chain_query(chosen[0]), chain_query(chosen[1])]), chosen_h[1]),
               (Or([chain_query(chosen[0]),
                    Link("Interacts", [Node("Gene", chosen[0]), Variable("V5")], True)]), None)]

    torch.cuda.synchronize()
    compiler.reset_route_counts()
    reset_launch_counts()
    tree_before = [tree_answer(das, q, str)[2] for q, _ in tree_qs]
    if tree_before != [tree_want(chosen_h[0], o) for _, o in tree_qs]:
        raise AssertionError("a pre-commit tree answer differs from numpy")
    # the serving batch, answered and cached on the pre-commit store
    before = das.query_many(batch)
    c0 = result_cache_stats(db)
    stars_auto = 0
    cache = None
    for k in range(3):
        nodes, links, new, partners = gene_commit(
            rng, ref, name_of, f"GENE:commit{k}_", 256, with_procs, procs,
            partners_first=chosen_h[:16] if k == 0 else ())
        commit(transaction(das, nodes, links), 256 + len(links))
        ref.record(db, links)
        new_h = [db.get_node_handle("Gene", n) for n in new]
        name_of.update(zip(new_h, new))
        if k == 0:
            # the serving batch again: one invalidation, no hits, new answers
            after = das.query_many(batch)
            c1 = result_cache_stats(db)
            cache = {key: c1[key] - c0[key] for key in c0}
            if cache["invalidations"] != 1 or cache["hits"]:
                raise AssertionError(f"the cache across a commit moved by {cache}")
            changed = 0
            for s, s0, (g, negate) in zip(after, before, keys):
                if parse_handles(s) != ref.grounded(g, negate):
                    raise AssertionError("a post-commit serving answer differs from numpy")
                changed += s != s0
            if changed < 16:
                raise AssertionError(f"the first commit changed {changed} serving answers")
            cache["changed_answers"] = changed
            # the cached tree answers are stale now: both answer anew
            tree_after = [tree_answer(das, q, str)[2] for q, _ in tree_qs]
            if (tree_after != [tree_want(chosen_h[0], o) for _, o in tree_qs]
                    or any(a == b for a, b in zip(tree_after, tree_before))):
                raise AssertionError("a tree answer after the commit is stale or differs")
            # get_links through the device probes against the host scan of
            # the same committed store, new genes and touched ones
            scan_db = MemoryDB(db.data)
            for g in new_h[:4] + partners[:4]:
                got = db.get_matched_links("Member", [g, "*"])
                if not got or sorted(got) != sorted(
                        scan_db.get_matched_links("Member", [g, "*"])):
                    raise AssertionError("get_links after the commit differs from the host scan")
            cache["tree_answers"] = [[len(a) for a in tree_before], [len(a) for a in tree_after]]
        check_answers(new_h[:16] + partners[:16])
        stars_auto += check_star(new_h[0], partners[0])

    # the fourth commit: 512 links among existing genes and processes; a
    # batch dispatched before it settles on the committed store
    touched, xs = chosen_h[16:32], []
    links = []
    nodes = {}
    for g in touched:
        partners = set(ref.partners(g))
        p0 = ref.procs(g)[0]
        x = next(v for v in ref.members(p0) if v != g and v not in partners)
        xs.append(x)
        links += [("Interacts", name_of_any(g), name_of_any(x)),
                  ("Interacts", name_of_any(x), name_of_any(g))]
        nodes[name_of_any(g)] = nodes[name_of_any(x)] = "Gene"
    new_members = set()
    while len(links) < 512:
        g, p = rng.choice(with_procs), rng.choice(procs)
        if p in ref.procs(g) or (g, p) in new_members:
            continue
        new_members.add((g, p))
        links.append(("Member", name_of_any(g), name_of[p]))
        nodes[name_of_any(g)] = "Gene"
        nodes[name_of[p]] = "BiologicalProcess"
    in_flight = [grounded_query(name_of_any(g)) for g in touched]
    pre = [ref.grounded(g, False) for g in touched]
    job = das.query_many_dispatch(in_flight)
    captured = []
    merge_padded = tensor_db._merge_padded

    def capture(*a):
        # references only: the inputs are never written, so they are copied
        # to the host after the commit, outside the timed staging
        out = merge_padded(*a)
        if not captured:
            captured.append((a, out))
        return out

    tensor_db._merge_padded = capture
    try:
        commit(transaction(das, nodes, links), len(links))
    finally:
        tensor_db._merge_padded = merge_padded
    ref.record(db, links)
    settled = job.settle()
    for s, g, p in zip(settled, touched, pre):
        want = ref.grounded(g, False)
        if parse_handles(s) != want or want == p:
            raise AssertionError("the batch dispatched before the commit missed it")
    check_answers(touched + xs)
    stars_auto += check_star(touched[0], xs[0])
    del db._stage_delta_merge
    # the merged indexes: structure, and one merge again on CPU copies
    n_cols = check_merged_bucket(db.dev.buckets[2])
    (ins, outs), = captured
    again = merge_padded(*(t.cpu() for t in ins))
    if not all(torch.equal(a, b.cpu()) for a, b in zip(again, outs)):
        raise AssertionError("the card's merge differs from the same merge on the CPU")

    # -- SMALL: capacity growth, a new arity, a threshold rebuild ------------------
    sdata, sgenes = build_kb(SMALL, args.seed)
    shost = HostKB(sdata, sgenes)
    sdas = DistributedAtomSpace(backend="tensor", data=sdata, device=DEVICE)
    smem = DistributedAtomSpace(backend="memory", data=sdata)
    sref = CommitRef(shost)
    sprocs = sorted({sref.hexes[p] for p in shost.member[:, 1].tolist()})
    sname = {h: sdata.nodes[h].name for h in sref.hexes[:len(sdata.nodes)]}
    sexisting = sorted({sref.hexes[g] for g in shost.member[:, 0].tolist()})
    sdb = sdas.db

    def small_commit(prefix, n_new):
        nodes, links, new, _partners = gene_commit(rng, sref, sname, prefix, n_new, sexisting,
                                                   sprocs)
        sdas.commit_transaction(transaction(sdas, nodes, links))
        sref.record(sdb, links)
        for n in new[:4]:
            for negate in (False, True):
                q = grounded_query(n, negate)
                if answer_set(sdas, q) != answer_set(smem, q):
                    raise AssertionError(f"SMALL {n} (not={negate}) differs from the host algebra")
        return len(new) + len(links)

    scap0 = sdb.dev.buckets[2].capacity
    grow_commits = 0
    while sdb.dev.buckets[2].capacity == scap0:
        total = sdb._delta_total
        atoms = small_commit(f"GENE:small{grow_commits}_", 40)
        grow_commits += 1
        if sdb._delta_total != total + atoms or grow_commits > 4:
            raise AssertionError("SMALL: the growth commits rebuilt or never grew")
    grown = {"commits": grow_commits, "capacity": [scap0, sdb.dev.buckets[2].capacity],
             "size": sdb.dev.buckets[2].size}
    # a new 3-ary link type: the delta becomes the base of its arity
    gnames = [sname[h] for h in sexisting[:17]]
    pname = sname[sprocs[0]]
    sdas.commit_transaction(transaction(
        sdas, {**{n: "Gene" for n in gnames}, pname: "BiologicalProcess"},
        [("Triple", gnames[0], gnames[i], pname) for i in range(1, 17)], types=("Triple",)))
    from das_tpu_torch.query.ast import Link, Node, Variable

    tq = Link("Triple", [Node("Gene", gnames[0]), Variable("V1"), Variable("V2")], True)
    if (3 not in sdb._base_buckets or sdb.dev.buckets[3].size != 16
            or len(answer_set(sdas, tq)[1]) != 16 or answer_set(sdas, tq) != answer_set(smem, tq)):
        raise AssertionError("SMALL: the new 3-ary link type is not its arity's base")
    # past a small threshold: a full rebuild
    sdb.config.delta_merge_threshold = sdb._delta_total + 8
    version = sdb.delta_version
    small_commit("GENE:rebuild_", 8)
    if sdas.db._delta_total != 0 or sdas.db.delta_version != version + 1:
        raise AssertionError("SMALL: the commit past the threshold did not rebuild")
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    routes = dict(compiler.ROUTE_COUNTS)
    idle = [k for k in ("probe", "index_join", "join_tables", "anti_join") if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the commit path: {idle}")
    emit({
        "phase": "commit", "card": smi,
        "commits": per_commit,
        "commit_ms_p50_of_3": _p50(commit_ms[:3]), "merge_ms_p50_of_3": _p50(merge_ms[:3]),
        "kb_finalize_upload_s": upload_s,
        "delta_total": db._delta_total, "delta_version": db.delta_version,
        "arity2": {"size": db.dev.buckets[2].size, "capacity": cap2},
        "store_tensor_bytes": nbytes,
        "p50_ms": {k: _p50(v) for k, v in times.items()}, "slice_p50_ms": slice_p50,
        "answers_checked": checked, "stars_multiway_auto": stars_auto,
        "cache": cache, "cache_stats": result_cache_stats(db),
        "in_flight": {"queries": len(in_flight)},
        "merged_columns_checked": n_cols,
        "small": {"growth": grown, "new_arity_rows": sdb.dev.buckets[3].size,
                  "rebuild_delta_version": sdas.db.delta_version},
        "routes": routes, "launches": launches, "phase_s": time.perf_counter() - t_phase,
    })
    return launches, {"ref": ref, "name_of": name_of, "procs": procs, "with_procs": with_procs,
                      "commit_ms_p50": _p50(commit_ms[:3])}


# ---- phase 10 --------------------------------------------------------------------


class TypeColumns:
    """The target columns of each link type of one arity, concatenated from
    the store's host segments (base and overlays): a candidate's count is a
    mask over them, with no sorted index and no host probe."""

    def __init__(self, db, arity=2):
        from das_tpu_torch.storage.atom_table import host_segments

        self.db = db
        segs = host_segments(db, arity)
        type_id = np.concatenate([b.type_id for b in segs])
        targets = np.concatenate([b.targets for b in segs])
        self.by_type = {int(t): targets[type_id == t] for t in np.unique(type_id)}

    def count(self, link):
        """Matches of one candidate: an ordered link pattern whose variables
        are distinct and appear once (a wildcard variant)."""
        from das_tpu_torch.query.ast import Node

        if not link.ordered:
            raise AssertionError(f"unordered candidate on the bio KB: {link!r}")
        cols = self.by_type.get(self.db._type_id(link.atom_type))
        if cols is None:
            return 0
        keep = np.ones(cols.shape[0], dtype=bool)
        for pos, t in enumerate(link.targets):
            if isinstance(t, Node):
                keep &= cols[:, pos] == self.db.fin.row_of_hex[
                    self.db.get_node_handle(t.atom_type, t.name)]
        return int(keep.sum())


def has_grounded(query):
    from das_tpu_torch.query.ast import Node

    return any(isinstance(t, Node) for term in query.terms for t in term.targets)


def star_three_way(db, queries):
    """Each star query counted three ways on `db`, every cache cleared
    first: (a) the host fold (`star_count_many`), (b) the device fold
    (`_device_count_group`), (c) where a term is grounded, `count_batch`
    (the general executors), and what it declines through
    `count_matches_staged` (the miner's own fallback).  Returns the counts of (a), (b) and (c) (None where left
    out) and a report: each way's seconds, (b)'s fetches, (c)'s launches,
    staged entries and left-outs by reason."""
    import torch

    from das_tpu_torch.core.exceptions import CapacityOverflowError
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler, starcount
    from das_tpu_torch.query.fused import get_executor

    plans = [compiler.plan_query(db, q) for q in queries]
    lanes = [starcount.plan_star(db, p) for p in plans]
    if any(lane is None for lane in lanes):
        raise AssertionError("a miner joint is not a star lane")
    report = {"staged": 0, "left_out": {}}
    db._star_host_cache = {}
    t0 = time.perf_counter()
    host = starcount.star_count_many(db, lanes)
    report["host_s"] = time.perf_counter() - t0
    db._star_deg_cache = {}
    f0 = starcount.FETCHES["n"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = starcount._device_count_group(db, lanes)
    torch.cuda.synchronize()
    report["device_s"] = time.perf_counter() - t0
    report["device_fetches"] = starcount.FETCHES["n"] - f0
    db._star_deg_cache = {}
    idx = [i for i, q in enumerate(queries) if has_grounded(q)]
    report["left_out"]["no grounded term (whole-table x whole-table)"] = len(queries) - len(idx)
    fused = [None] * len(queries)
    ex = get_executor(db)
    ex.results.clear()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for i, n in zip(idx, ex.count_batch([plans[i] for i in idx])):
        if n is None:
            report["staged"] += 1
            try:
                n = compiler.count_matches_staged(db, plans[i])
            except CapacityOverflowError:
                out = report["left_out"]
                out["past max_result_capacity"] = out.get("past max_result_capacity", 0) + 1
                continue
        fused[i] = n
    torch.cuda.synchronize()
    report["fused_s"] = time.perf_counter() - t0
    report["launches"] = {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS}
    return host, dev, fused, report


def phase_miner(args, das, smi):
    """The pattern miner on the committed store (overlay segments live), as
    bench.py `_miner` runs it: PatternMiner(halo_length=2, link_rate=0.01,
    seed=7) on the first 3 genes, expand_halo, build_patterns, mine(ngram=3,
    epochs=100); counters zeroed before, read after.  Every candidate's
    count is held against numpy over the host link columns.  Then the
    drawn composites with a grounded term and their 2-term sub-joints are
    counted by the host fold, the device fold and count_batch (the probe
    and join kernels), all equal; and the animals KB's miner on the card
    equals the memory backend's."""
    import torch

    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.mining import PatternMiner
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.query import compiler, fused, starcount, tree
    from das_tpu_torch.storage.atom_table import load_metta_text
    from das_tpu_torch.storage.memory_db import MemoryDB
    from das_tpu_torch.storage.tensor_db import TensorDB

    t_phase = time.perf_counter()
    db = das.db
    total = dict.fromkeys(TPU_KERNELS, 0)

    # -- the bench's miner at FlyBase shape --------------------------------------
    miner = PatternMiner(db, halo_length=2, link_rate=0.01, seed=7)
    batches = []                      # each count_many call's queries, in order
    count_many = miner.count_many
    miner.count_many = lambda queries: batches.append(list(queries)) or count_many(queries)
    seeds = [db.get_node_handle("Gene", g) for g in db.get_all_nodes("Gene", names=True)[:3]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    universe = miner.expand_halo(seeds)
    halo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_candidates = miner.build_patterns()
    count_s = time.perf_counter() - t0
    compiler.reset_route_counts()
    f0 = fused.FETCH_COUNTS["n"] + starcount.FETCHES["n"]
    t0 = time.perf_counter()
    best = miner.mine(ngram=3, epochs=100)
    mine_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    joint_routes = {k: v for k, v in compiler.ROUTE_COUNTS.items() if v}
    joint_fetches = fused.FETCH_COUNTS["n"] + starcount.FETCHES["n"] - f0
    mine_launches = {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS}
    for k in TPU_KERNELS:
        total[k] += mine_launches[k]
    if best is None or n_candidates == 0:
        raise AssertionError("the miner found no candidate or no pattern")
    cols = TypeColumns(db)
    wrong = [(repr(c.pattern), c.count, cols.count(c.pattern))
             for level in miner.candidates for c in level if cols.count(c.pattern) != c.count]
    if wrong:
        raise AssertionError(f"{len(wrong)} candidate counts differ from numpy: {wrong[:4]}")

    # -- the star fold held against the kernels ---------------------------------
    # the drawn composites with a grounded term, and the 2-term sub-joints
    # the miner counted for its scores (batches: build_patterns, mine's
    # composites, _prefetch_joints)
    composites = list({repr(q): q for q in batches[1] if has_grounded(q)}.values())
    joints = batches[2] if len(batches) > 2 else []
    queries = composites + joints
    host, dev, fused_counts, three_way = star_three_way(db, queries)
    check_launches = three_way["launches"]
    for k in TPU_KERNELS:
        total[k] += check_launches[k]
    if host != dev:
        bad = [i for i in range(len(queries)) if host[i] != dev[i]]
        raise AssertionError(f"device fold differs from the host fold at {bad[:8]}")
    bad = [i for i, n in enumerate(fused_counts) if n is not None and n != host[i]]
    if bad:
        raise AssertionError(f"count_batch differs from the host fold at {bad[:8]}: "
                             f"{[(host[i], fused_counts[i]) for i in bad[:8]]}")
    compared = sum(fused_counts[i] is not None for i in range(len(composites)))
    if compared < 32:
        raise AssertionError(f"only {compared} grounded composites were counted three ways")
    # a check of zeros against zeros shows little: at least 32 of the
    # compared composites must have matches
    compared_nonzero = sum(n is not None and n > 0 for n in fused_counts[:len(composites)])
    if compared_nonzero < 32:
        raise AssertionError(f"only {compared_nonzero} of the composites counted three ways "
                             "have a match")
    if check_launches["probe"] == 0 or not any(
            check_launches[k] for k in ("index_join", "join_tables", "multiway")):
        raise AssertionError(f"count_batch launched no probe or no join: {check_launches}")
    miner_best = dict(zip(map(repr, queries), host)).get(repr(best.pattern))
    if miner_best is not None and miner_best != best.count:
        raise AssertionError("the best pattern's count differs from the host fold's")

    # -- the animals KB on the card against the memory backend ------------------
    def animals_run(store):
        m = PatternMiner(store, halo_length=2, link_rate=1.0, seed=3)
        m.expand_halo(["af12f10f9ae2002a1607ba0b47ba8407"])
        m.build_patterns()
        out = [(repr(c.pattern), c.count, c.level) for lv in m.candidates for c in lv]
        for b in (m.mine(ngram=2, epochs=30), m.mine_exhaustive(ngram=2)):
            out.append((repr(b.pattern), b.count, b.isurprisingness, b.term_handles))
        return out

    tree_calls = []
    query_tree = tree.query_tree
    tree.query_tree = lambda *a, **kw: tree_calls.append(1) or query_tree(*a, **kw)
    try:
        adb = TensorDB(load_metta_text(animals_metta()), device=DEVICE)
        reset_launch_counts()
        got = animals_run(adb)
        torch.cuda.synchronize()
        animal_launches = {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS}
    finally:
        tree.query_tree = query_tree
    want = animals_run(MemoryDB(load_metta_text(animals_metta())))
    if got != want:
        raise AssertionError("the animals miner on the card differs from the memory backend's")
    if not tree_calls or animal_launches["join_tables"] == 0:
        raise AssertionError("the animals miner's unordered candidates launched no tree join")
    for k in TPU_KERNELS:
        total[k] += animal_launches[k]

    emit({
        "phase": "miner", "card": smi,
        "halo_links": universe, "candidates": n_candidates,
        "halo_s": halo_s, "counting_s": count_s, "joints_s": mine_s,
        "ms_per_halo_link": (halo_s + count_s + mine_s) / max(universe, 1) * 1e3,
        "joint_routes": joint_routes, "joint_host_fetches": joint_fetches,
        "mine_launches": mine_launches, "best_count": best.count,
        "best_isurprisingness": best.isurprisingness,
        "candidates_checked": sum(len(lv) for lv in miner.candidates),
        "three_way": {"composites": len(composites), "sub_joints": len(joints),
                      "fused_compared": sum(n is not None for n in fused_counts),
                      "composites_compared": compared,
                      "nonzero": sum(n > 0 for n in host),
                      "composites_compared_nonzero": compared_nonzero,
                      **three_way},
        "animals": {"rows": len(want), "tree_calls": len(tree_calls),
                    "launches": animal_launches},
        "launches": total, "phase_s": time.perf_counter() - t_phase,
    })
    return total


# ---- phase 11 --------------------------------------------------------------------


def service_traffic(args, data, genes, host):
    """256 request strings in the query DSL for phase service: 96 grounded
    and 96 Not queries and 48 grounded stars, over genes no earlier phase
    drew, then 16 exact duplicates; and the genes of the grounded part."""
    gene_names = [data.nodes[h].name for h in genes]
    used = set(pick_genes(host, gene_names, args.seed))

    def name(r):
        return data.nodes[host.fin.hex_of_row[r]].name

    fresh = other_genes(host, gene_names, used, args.seed + 41, n=96, n_nonempty=64)
    rng = random.Random(args.seed + 43)
    stars = []
    for g in rng.sample(sorted(set(host.interacts[:, 0].tolist())), 48):
        x = int(host.partners(g)[0])
        procs = sorted(host.procs(x).tolist())
        p1, p2 = procs[-2:] if len(procs) > 1 else (procs[0], procs[0])
        stars.append((name(g), name(p1), name(p2)))

    def grounded(g, negate):
        return (f"Node g Gene {g}, Link Member g $V3, Link Member $V2 $V3, "
                f"Link Interacts g $V2{', NOT' if negate else ''}, AND")

    dsl = [grounded(g, False) for g in fresh] + [grounded(g, True) for g in fresh]
    dsl += [f"Node p1 BiologicalProcess {p1}, Node p2 BiologicalProcess {p2}, "
            f"Node g Gene {g}, Link Member $V1 p1, Link Member $V1 p2, "
            f"Link Interacts g $V1, AND" for g, p1, p2 in stars]
    dsl += [dsl[i] for i in range(0, 240, 15)]
    return dsl, fresh


def drive_clients(svc, key, dsl, n_clients=8):
    """`n_clients` threads, each sending its share of `dsl` as query request
    dicts one after another.  Returns (statuses in dsl order, RPC ms each,
    wall s)."""
    import threading

    out = [None] * len(dsl)
    ms = [None] * len(dsl)

    def client(k):
        for i in range(k, len(dsl), n_clients):
            t0 = time.perf_counter()
            out[i] = svc.query({"key": key, "query": dsl[i]})
            ms[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(s is None for s in out):
        raise AssertionError("phase service: a client thread did not finish")
    return out, ms, wall


def _pct(values, q):
    return float(np.percentile(np.asarray(values, dtype=float), q))


def worker_split(events, wall_s):
    """The coalescer worker's time in one traced pass, from its spans:
    per name the count and summed ms, the settle's own fetch waits
    (`exec.settle_fetch`, nested in `serve.settle`), its per-query
    fallbacks, and the share of the pass's wall the worker spent in
    group, dispatch and settle (the rest is `serve.drain`, which holds
    its blocking wait for work, and the loop itself)."""
    out = {"wall_ms": wall_s * 1e3}
    for name in ("serve.drain", "serve.group", "serve.dispatch", "serve.settle",
                 "exec.settle_fetch"):
        durs = [e[3] for e in events if e[0] == name and e[1] == "X"]
        out[name] = {"n": len(durs), "ms": sum(durs) * 1e3}
    out["fallbacks"] = sum(int((e[8] or {}).get("fallbacks") or 0)
                           for e in events if e[0] == "serve.settle")
    busy = sum(out[n]["ms"] for n in ("serve.group", "serve.dispatch", "serve.settle"))
    out["worker_busy_share"] = busy / out["wall_ms"]
    return out


def clear_result_caches(das):
    ex = das.db.dev._fused_executor
    ex.results.clear()
    ex.tree_results.clear()


def phase_service(args, das, data, genes, host, smi):
    """The service on the committed store (attach_tenant, no rebuild),
    driven through DasService's request dicts — the methods the gRPC
    servicer adapts; the card machine has no grpc.  8 client threads x 32
    DSL queries (grounded, Not and grounded-star families, 16 exact
    duplicates) through the tenant's coalescer: every answer equal to
    serial query()'s, fewer batches than items, >= 2 groups in flight.
    Then: the same traffic traced (spans per name, a Chrome trace written
    and read back, the serving gauges in metrics_text, the worker's time
    split by its spans); two more alternating pairs of untraced and traced
    passes (p50 off and on, with their spread); the traffic again under a seeded fault plan over the five serving
    sites (every site fired, fault.retries > 0, answers equal but the
    typed submit_queue statuses); group k's settle returning while a sleep
    kernel queued before group k+1 still runs (its own CUDA event); the
    breaker (a terminal settle failure trips it, a cached query answers
    with 0 launches, an uncached one is a breaker_open status, the probe
    restores service: trips 1, recoveries 1); a typed deadline status
    behind a sleep kernel; and a commit with commit_apply injected once,
    landing on retry while queries are in flight, its links in the answers
    after it."""
    import tempfile
    import threading

    import torch

    from das_tpu_torch import fault, obs
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query.fused import FETCH_COUNTS
    from das_tpu_torch.service import protocol
    from das_tpu_torch.service.query_dsl import parse_query
    from das_tpu_torch.service.server import DasService

    t_phase = time.perf_counter()
    total = dict.fromkeys(TPU_KERNELS, 0)
    dsl, fresh = service_traffic(args, data, genes, host)
    parsed = [parse_query(q) for q in dsl]
    if any(p is None for p in parsed):
        raise AssertionError("phase service: a DSL query did not parse")
    t0 = time.perf_counter()
    want = [das.query(q) for q in parsed]
    serial_ms = (time.perf_counter() - t0) * 1e3 / len(parsed)
    if sum(bool(w) for w in want) < 64:
        raise AssertionError("phase service: too few non-empty answers to prove anything")
    svc = DasService(backend="tensor")
    key = svc.attach_tenant("flybase", das)

    def check(statuses, what, typed_ok=()):
        typed = 0
        for i, (s, w) in enumerate(zip(statuses, want)):
            if s["success"] and s["msg"] == w:
                continue
            if not s["success"] and any(s["msg"].startswith(p) for p in typed_ok):
                typed += 1
                continue
            raise AssertionError(f"{what}: entry {i} differs from serial query(): {s['msg'][:120]}")
        return typed

    # -- the coalesced traffic, tracing off --------------------------------------
    clear_result_caches(das)
    torch.cuda.synchronize()
    reset_launch_counts()
    f0 = FETCH_COUNTS["n"]
    statuses, rpc_ms, wall = drive_clients(svc, key, dsl)
    torch.cuda.synchronize()
    launches = {k: LAUNCH_COUNTS[k] for k in TPU_KERNELS}
    fetches = FETCH_COUNTS["n"] - f0
    check(statuses, "coalesced traffic")
    idle = [k for k in ("probe", "index_join", "join_tables", "anti_join") if not launches[k]]
    if idle:
        raise AssertionError(f"phase service launched no {idle}")
    stats = svc.coalescer_stats()
    if not stats["batches"] < stats["items"] == len(dsl) or stats["inflight_peak"] < 2:
        raise AssertionError(f"phase service did not coalesce and pipeline: {stats}")
    for k in TPU_KERNELS:
        total[k] += launches[k]
    coalesced = {
        "queries": len(dsl), "clients": 8, "wall_s": wall, "qps": len(dsl) / wall,
        "rpc_p50_ms": _pct(rpc_ms, 50), "rpc_p99_ms": _pct(rpc_ms, 99),
        "serial_query_ms": serial_ms, "host_fetches": fetches,
        "fetches_per_query": fetches / len(dsl), "launches": launches,
        "batches": stats["batches"], "items": stats["items"], "max_batch": stats["max_batch"],
        "inflight_peak": stats["inflight_peak"], "effective_depth": stats["effective_depth"],
        "rtt_ewma_ms": stats["rtt_ewma_ms"], "dispatch_ewma_ms": stats["dispatch_ewma_ms"],
        "speculative_dispatches": stats["speculative_dispatches"],
        "early_settles": stats["early_settles"],
    }

    # -- the same traffic traced --------------------------------------------------
    clear_result_caches(das)
    obs.reset()
    obs.configure(enabled=True)
    reset_launch_counts()
    try:
        traced, traced_ms, traced_wall = drive_clients(svc, key, dsl)
        for k in TPU_KERNELS:
            total[k] += LAUNCH_COUNTS[k]
        check(traced, "traced traffic")
        events = obs.events()
        spans = {}
        for e in events:
            spans[e[0]] = spans.get(e[0], 0) + 1
        for name in ("serve.submit", "serve.drain", "serve.group", "serve.plan",
                     "serve.dispatch", "serve.settle", "serve.answer", "exec.dispatch",
                     "exec.settle_fetch", "exec.materialize", "cache.miss"):
            if not spans.get(name):
                raise AssertionError(f"phase service: no {name} span in the trace")
        tmp = tempfile.mkdtemp(prefix="das_trace_")
        try:
            path = obs.dump_chrome_trace(events, os.path.join(tmp, "trace.json"))
            with open(path) as f:
                back = json.load(f)
            trace_bytes = os.path.getsize(path)
        finally:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
        n_x = sum(1 for e in back["traceEvents"] if e["ph"] in ("X", "i"))
        if n_x != len(events):
            raise AssertionError(f"chrome trace holds {n_x} events of {len(events)}")
        text = svc.metrics_text()
        gauges = ("serving_batches", "serving_items", "serving_inflight_peak",
                  "serving_effective_depth", "serving_rtt_ewma_ms", "serving_dispatch_ewma_ms")
        missing = [g for g in gauges if f"das_tpu_obs_{g} " not in text]
        if missing or f"das_tpu_obs_serve_answers_total {len(dsl)}" not in text:
            raise AssertionError(f"metrics_text lacks {missing} or the answer count")
        tracing = {"p50_off_ms": coalesced["rpc_p50_ms"], "p50_on_ms": _pct(traced_ms, 50),
                   "p99_on_ms": _pct(traced_ms, 99), "events": len(events),
                   "spans": spans, "chrome_trace_bytes": trace_bytes,
                   "answer_ms_p50": obs.histogram("serve.answer_ms").percentile(0.5),
                   "worker": worker_split(events, traced_wall)}

        # -- the off / on spread: two more pairs of passes, alternating ----------
        p50s = {"off": [coalesced["rpc_p50_ms"]], "on": [tracing["p50_on_ms"]]}
        qps = {"off": [coalesced["qps"]], "on": [len(dsl) / traced_wall]}
        for _ in range(2):
            for mode in ("off", "on"):
                clear_result_caches(das)
                obs.reset()
                obs.configure(enabled=mode == "on")
                reset_launch_counts()
                repeat, repeat_ms, repeat_wall = drive_clients(svc, key, dsl)
                for k in TPU_KERNELS:
                    total[k] += LAUNCH_COUNTS[k]
                check(repeat, f"repeated traffic, tracing {mode}")
                p50s[mode].append(_pct(repeat_ms, 50))
                qps[mode].append(len(dsl) / repeat_wall)
        obs.configure(enabled=True)
        tracing.update(p50_off_passes_ms=p50s["off"], p50_on_passes_ms=p50s["on"],
                       qps_off_passes=qps["off"], qps_on_passes=qps["on"])

        # -- chaos: the traffic under a seeded plan over the serving sites -------
        sites = ("settle_fetch", "cache_insert", "dispatch_enqueue", "worker_iteration",
                 "submit_queue")
        clear_result_caches(das)
        obs.reset()
        fault.reset_counts()
        reset_launch_counts()
        fault.configure(f"seed={args.seed + 7};sites={','.join(sites)};rate=0.1;max=6")
        try:
            chaos, chaos_ms, chaos_wall = drive_clients(svc, key, dsl)
        finally:
            fault.configure(None)
        for k in TPU_KERNELS:
            total[k] += LAUNCH_COUNTS[k]
        typed = check(chaos, "chaos traffic", typed_ok=("injected fault at site 'submit_queue'",))
        fired = {s: fault.INJECT_COUNTS[s] for s in sites}
        retries = obs.counter("fault.retries").value
        if min(fired.values()) == 0 or retries == 0:
            raise AssertionError(f"chaos: sites fired {fired}, fault.retries {retries}")
        if typed != fired["submit_queue"]:
            raise AssertionError(f"chaos: {typed} typed statuses for {fired['submit_queue']} "
                                 "submit_queue injections")
        chaos_out = {"spec_rate": 0.1, "fired": fired, "retries": retries,
                     "typed_submit_statuses": typed, "qps": len(dsl) / chaos_wall,
                     "rpc_p50_ms": _pct(chaos_ms, 50), "rpc_p99_ms": _pct(chaos_ms, 99)}
    finally:
        fault.configure(None)
        obs.configure(enabled=False)
        obs.reset()

    # -- group k's settle waits on its own event, not on group k+1 ---------------
    cfg = das.db.config
    size, cfg.result_cache_size = cfg.result_cache_size, 0
    try:
        group_k = [parsed[i] for i in range(16) if want[i]]
        group_k1 = parsed[16:32]
        want_k = [w for w in want[:16] if w]
        das.query_many(group_k)           # capacities learned: one round each
        das.query_many(group_k1)
        reset_launch_counts()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        job_k = das.query_many_dispatch(group_k)
        torch.cuda._sleep(1_000_000_000)
        job_k1 = das.query_many_dispatch(group_k1)
        got_k = [a for _i, a in sorted(job_k.settle_iter(), key=lambda x: x[0])]
        settle_k_ms = (time.perf_counter() - t0) * 1e3
        got_k1 = job_k1.settle()
        torch.cuda.synchronize()
        sleep_end_ms = (time.perf_counter() - t0) * 1e3
        for k in TPU_KERNELS:
            total[k] += LAUNCH_COUNTS[k]
    finally:
        cfg.result_cache_size = size
    if got_k != want_k or got_k1 != want[16:32]:
        raise AssertionError("pipelined groups: answers differ from serial query()")
    if settle_k_ms * 4 > sleep_end_ms:
        raise AssertionError(f"group k's settle waited for group k+1: {settle_k_ms} ms of "
                             f"{sleep_end_ms}")
    print(f"service pipelining: group k settled at {settle_k_ms:.3f} ms, the sleep kernel "
          f"before group k+1 ended at {sleep_end_ms:.3f} ms", flush=True)

    # -- the breaker: a terminal settle failure trips it --------------------------
    saved = (cfg.breaker_failure_threshold, cfg.breaker_cooldown_ms)
    cfg.breaker_failure_threshold, cfg.breaker_cooldown_ms = 1, 400
    try:
        bkey = svc.attach_tenant("breaker", das)
        svc.query({"key": bkey, "query": dsl[0]})     # creates its coalescer
    finally:
        cfg.breaker_failure_threshold, cfg.breaker_cooldown_ms = saved
    hot, trip, cold = dsl[1], dsl[2], dsl[3]
    clear_result_caches(das)
    if svc.query({"key": bkey, "query": hot})["msg"] != want[1]:
        raise AssertionError("breaker: the hot query's first answer differs")
    fault.configure("seed=9;sites=settle_fetch;every=1;max=1000")
    try:
        tripped = svc.query({"key": bkey, "query": trip})
    finally:
        fault.configure(None)
    bstats = svc.coalescer_stats()["tenants"]["breaker"]
    if tripped["msg"] != want[2] or bstats["breaker_state"] != "open":
        raise AssertionError(f"breaker: not open after a terminal settle failure: {bstats}")
    reset_launch_counts()
    hot_again = svc.query({"key": bkey, "query": hot})
    hot_launches = sum(LAUNCH_COUNTS.values())
    rejected = svc.query({"key": bkey, "query": cold})
    hint = protocol.parse_retryable(rejected["msg"])
    if hot_again["msg"] != want[1] or hot_launches:
        raise AssertionError(f"breaker: cached query under an open breaker: {hot_launches} "
                             "launches or a different answer")
    if hint is None or hint["kind"] != "breaker_open":
        raise AssertionError(f"breaker: the uncached query was not rejected typed: {rejected}")
    time.sleep(0.45)
    reset_launch_counts()
    probe = svc.query({"key": bkey, "query": cold})
    for k in TPU_KERNELS:
        total[k] += LAUNCH_COUNTS[k]
    # the worker records the group's verdict after it resolved the probe's
    # future, so the answer can reach this thread first: wait for it
    deadline = time.perf_counter() + 5.0
    while True:
        bstats = svc.coalescer_stats()["tenants"]["breaker"]
        if bstats["breaker_state"] != "half_open" or time.perf_counter() > deadline:
            break
        time.sleep(0.01)
    if probe["msg"] != want[3] or (bstats["breaker_trips"], bstats["breaker_recoveries"]) != (1, 1):
        raise AssertionError(f"breaker: the probe did not restore service: {bstats}")
    breaker = {"trips": bstats["breaker_trips"], "recoveries": bstats["breaker_recoveries"],
               "rejections": bstats["breaker_rejections"], "hot_launches": hot_launches,
               "retry_after_ms": hint["retry_after_ms"], "state": bstats["breaker_state"]}

    # -- a deadline behind a sleep kernel -----------------------------------------
    saved = (cfg.query_deadline_ms, cfg.coalesce_max_batch, cfg.pipeline_depth)
    cfg.query_deadline_ms, cfg.coalesce_max_batch, cfg.pipeline_depth = 100, 1, 1
    try:
        dkey = svc.attach_tenant("deadline", das)
        svc.query({"key": dkey, "query": dsl[4]})     # creates its coalescer
    finally:
        cfg.query_deadline_ms, cfg.coalesce_max_batch, cfg.pipeline_depth = saved
    clear_result_caches(das)
    reset_launch_counts()
    dl = {}
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    first = threading.Thread(target=lambda: dl.setdefault(
        "first", svc.query({"key": dkey, "query": dsl[5]})), daemon=True)
    first.start()
    time.sleep(0.03)
    late = svc.query({"key": dkey, "query": dsl[6]})
    first.join(timeout=60)
    torch.cuda.synchronize()
    for k in TPU_KERNELS:
        total[k] += LAUNCH_COUNTS[k]
    dhint = protocol.parse_retryable(late["msg"])
    if dhint is None or dhint["kind"] != "deadline":
        raise AssertionError(f"deadline: the queued query was not a typed deadline: {late}")
    if dl.get("first", {}).get("msg") != want[5]:
        raise AssertionError("deadline: the dispatched query's late answer differs")
    deadline = {"deadline_ms": 100, "status": late["msg"].split(" ")[1],
                "expired": svc.coalescer_stats()["tenants"]["deadline"]["deadline_expired"]}

    # -- a commit under load, commit_apply injected once -------------------------
    g = fresh[0]
    tx = das.open_transaction()
    tx.add(f'(: "{g}" Gene)')
    tx.add('(: "GENE:served" Gene)')
    tx.add(f'(Interacts "{g}" "GENE:served")')
    version = das.db.delta_version
    stop = threading.Event()
    during = []

    def load():
        i = 64
        while not stop.is_set():
            during.append((i % 240, svc.query({"key": key, "query": dsl[i % 240]})))
            i += 1

    clear_result_caches(das)
    reset_launch_counts()
    loaders = [threading.Thread(target=load, daemon=True) for _ in range(4)]
    for t in loaders:
        t.start()
    time.sleep(0.05)
    fault.reset_counts()
    fault.configure("seed=3;sites=commit_apply;every=1;max=1")
    try:
        with svc.tenants[key].lock:
            das.commit_transaction(tx)
    finally:
        fault.configure(None)
    time.sleep(0.05)
    stop.set()
    for t in loaders:
        t.join(timeout=60)
    for k in TPU_KERNELS:
        total[k] += LAUNCH_COUNTS[k]
    if fault.INJECT_COUNTS["commit_apply"] != 1 or das.db.delta_version != version + 1:
        raise AssertionError("commit under load: the injected commit did not land on retry")
    # the commit adds an Interacts link to a gene without Member links: no
    # answer of the traffic changes, whichever side of the swap it lands
    bad = [i for i, s in during if not s["success"] or s["msg"] != want[i]]
    if bad or not during:
        raise AssertionError(f"commit under load: {len(bad)} of {len(during)} answers differ")
    new = das.db.get_node_handle("Gene", "GENE:served")
    after = svc.query({"key": key, "query": f"Node g Gene {g}, Link Interacts g $V2"})
    if new not in after["msg"] or after["msg"] != das.query(
            parse_query(f"Node g Gene {g}, Link Interacts g $V2")):
        raise AssertionError("commit under load: the new link is not in the answer")
    commit = {"queries_during": len(during), "injected": 1, "delta_version": das.db.delta_version}

    line = {
        "phase": "service", "card": smi, "coalesced": coalesced, "tracing": tracing,
        "chaos": chaos_out,
        "pipelining": {"settle_k_ms": settle_k_ms, "sleep_end_ms": sleep_end_ms},
        "breaker": breaker, "deadline": deadline, "commit": commit, "launches": total,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(line)
    print(f"service: {coalesced['qps']:.1f} queries/s, RPC p50 {coalesced['rpc_p50_ms']:.3f} ms "
          f"p99 {coalesced['rpc_p99_ms']:.3f} ms, {coalesced['fetches_per_query']:.4f} fetches "
          f"per query, launches {launches}, effective_depth {coalesced['effective_depth']}, "
          f"rtt_ewma_ms {coalesced['rtt_ewma_ms']}, dispatch_ewma_ms "
          f"{coalesced['dispatch_ewma_ms']}; RPC p50 with tracing off "
          f"{[round(p, 3) for p in tracing['p50_off_passes_ms']]} ms, on "
          f"{[round(p, 3) for p in tracing['p50_on_passes_ms']]} ms; the worker busy "
          f"{tracing['worker']['worker_busy_share']:.4f} of the traced pass", flush=True)
    return total


def host_tables(db):
    """Host copies of every device table of a store: the CSR, and per
    bucket its size, capacity, every column, posting key and perm."""
    from das_tpu_torch.storage.tensor_db import BUCKET_LIST_PADS, BUCKET_PADS

    dev = db.dev
    out = {name: getattr(dev, name).cpu().numpy()
           for name in ("node_type_id", "incoming_offsets", "incoming_links")}
    for arity, b in dev.buckets.items():
        out[f"b{arity}.shape"] = np.array([b.size, b.capacity])
        for name, _ in BUCKET_PADS:
            out[f"b{arity}.{name}"] = getattr(b, name).cpu().numpy()
        for name, _ in BUCKET_LIST_PADS:
            for p, t in enumerate(getattr(b, name)):
                out[f"b{arity}.{name}[{p}]"] = t.cpu().numpy()
    return out


def assert_same_tables(want, got, what):
    """Raise unless two host_tables are equal bit for bit (dtype, shape,
    values); returns the number of arrays compared."""
    if sorted(want) != sorted(got):
        raise AssertionError(f"{what}: the restored store has other tables")
    for k, w in want.items():
        g = got[k]
        if w.dtype != g.dtype or w.shape != g.shape or not np.array_equal(w, g):
            raise AssertionError(f"{what}: {k} differs from the dead store's")
    return len(want)


class Timed:
    """While active, `obj.attr` is wrapped to add each call's wall seconds
    to `sink[key(args)]` (by default under `attr`) and count its calls in
    `n`."""

    def __init__(self, sink, obj, attr, key=None):
        self.sink, self.obj, self.attr = sink, obj, attr
        self.key = key or (lambda *a: attr)
        self.n = 0

    def __enter__(self):
        self._fn = fn = getattr(self.obj, self.attr)
        self._own = self.attr in vars(self.obj)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            k = self.key(*a)
            self.sink[k] = self.sink.get(k, 0.0) + time.perf_counter() - t0
            self.n += 1
            return out

        setattr(self.obj, self.attr, timed)
        return self

    def __exit__(self, *exc):
        if self._own:
            setattr(self.obj, self.attr, self._fn)
        else:
            delattr(self.obj, self.attr)
        return False


class FinRelease:
    """While active, times apart the host-store add that drops
    `data._fin` (the host Finalized a snapshot's `data.finalize()` leaves
    cached) into `ms`; None when no add dropped one."""

    def __init__(self, data):
        self.data = data

    def __enter__(self):
        self.ms = None
        for attr in ("add_terminal", "add_link"):
            fn = getattr(self.data, attr)

            def timed(*a, _fn=fn, **kw):
                held = self.data._fin is not None
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                if held and self.data._fin is None:
                    self.ms = (time.perf_counter() - t0) * 1e3
                return out

            setattr(self.data, attr, timed)
        return self

    def __exit__(self, *exc):
        delattr(self.data, "add_terminal")
        delattr(self.data, "add_link")
        return False


class GcPauses:
    """While active, sums the cyclic collector's pauses (gc.callbacks) in
    `ms` and counts them by generation."""

    def __enter__(self):
        import gc

        self.ms, self.by_gen, self._t0 = 0.0, {}, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            gen = str(info["generation"])
            self.by_gen[gen] = self.by_gen.get(gen, 0) + 1
            self._t0 = None

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._note)
        return False


class ConjRounds:
    """While active, counts conjunction rounds (_ExecJob.dispatch calls)."""

    def __enter__(self):
        from das_tpu_torch.query import fused

        self.n = 0
        self._fn = fn = fused._ExecJob.dispatch

        def dispatch(job):
            self.n += 1
            return fn(job)

        fused._ExecJob.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from das_tpu_torch.query import fused

        fused._ExecJob.dispatch = self._fn
        return False


def durable_families(args, data, host, ref, name_of):
    """The families the durable phase answers on the restored store, in
    handle space: {name: [(query, numpy answer)]}: phase slice's 32
    grounded queries and their Not variants, phase planned's 32 grounded
    stars, and phase tree's 16 Ors of two grounded chains, each answer
    from CommitRef (the pre-commit HostKB plus every pair written)."""
    from das_tpu_torch.query.ast import Or

    def name(h):
        return name_of.get(h) or data.nodes[h].name

    hexes = host.fin.hex_of_row
    gene_names = [data.nodes[hexes[r]].name for r in host.gene_rows.tolist()]
    handle = {data.nodes[hexes[r]].name: hexes[r] for r in host.gene_rows.tolist()}
    chosen = pick_genes(host, gene_names, args.seed)
    stars, _fan = star_rows(args, host)
    picks = pick_genes(host, gene_names, args.seed + 11, n=48, n_nonempty=16)

    def chain(h):
        return {frozenset({("V2", m), ("V3", p)}) for p in ref.procs(h) for m in ref.members(p)}

    return {
        "grounded": [(grounded_query(g), ref.grounded(handle[g], False)) for g in chosen],
        "not": [(grounded_query(g, True), ref.grounded(handle[g], True)) for g in chosen],
        "grounded_star": [
            (grounded_star_query(name(hexes[g]), name(hexes[p1]), name(hexes[p2])),
             ref.grounded_star(hexes[g], hexes[p1], hexes[p2])) for g, p1, p2 in stars],
        "or2": [(Or([chain_query(picks[i]), chain_query(picks[16 + i])]),
                 chain(handle[picks[i]]) | chain(handle[picks[16 + i]])) for i in range(16)],
    }


def family_answers(das, families):
    """{family: [answer in handle space]} and the multiway route's count;
    a star family that auto routed to no multiway step runs again with the
    step on."""
    from das_tpu_torch.query import compiler

    out, routed = {}, 0
    for fam, queries in families.items():
        r0 = compiler.ROUTE_COUNTS["fused_multiway"]
        out[fam] = [tree_answer(das, q, str)[2] for q, _want in queries]
        if fam == "grounded_star":
            routed = compiler.ROUTE_COUNTS["fused_multiway"] - r0
            if not routed:
                cfg = das.db.config
                mode, cfg.use_multiway = cfg.use_multiway, "on"
                try:
                    out[fam] = [tree_answer(das, q, str)[2] for q, _want in queries]
                finally:
                    cfg.use_multiway = mode
                if compiler.ROUTE_COUNTS["fused_multiway"] == r0:
                    raise AssertionError("the restored store's stars took no multiway step")
    return out, routed


def phase_durable(args, holder, data, genes, host, smi, kb, commit):
    """Durability on the card, last since it ends the slice's store: a
    snapshot of the committed FlyBase-shaped store, two commits with the
    WAL armed, the store dropped and restored through the facade, and
    four query families on the restored store against the dead store's
    answers and numpy's; then on SMALL a restore bit-equal to the dead
    store, a torn WAL tail, a corrupt section and the warm bundle.  The
    counters are zeroed just before the restored store's families and
    read just after."""
    import gc
    import shutil
    import tempfile

    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.query import compiler, fused
    from das_tpu_torch.storage import atom_table, checkpoint, durable

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="das_durable_")
    try:
        disk = shutil.disk_usage(root)
        print(f"durable root {root}: disk total {disk.total} used {disk.used} free {disk.free}",
              flush=True)
        das = holder.pop("das")
        db = das.db
        ref, name_of = commit["ref"], commit["name_of"]
        rng = random.Random(args.seed + 10)
        lineage = os.path.join(root, das.database_name)
        durable.reset_stats()

        # -- the snapshot, timed by part: the host finalize, the payloads'
        # building and encoding (records, registry, warm bundle, in order),
        # each section's write and fsync
        snap_parts, encodes = {}, iter(("encode records", "encode registry", "encode warm"))
        fin = db.fin
        with Timed(snap_parts, data, "finalize"), \
                Timed(snap_parts, checkpoint, "_records_payload"), \
                Timed(snap_parts, durable, "encode", key=lambda *a: next(encodes)), \
                Timed(snap_parts, durable, "atomic_write",
                      key=lambda path, *a: f"write {os.path.basename(path)}"):
            t0 = time.perf_counter()
            gen = das.save_snapshot(lineage)
            snapshot_s = time.perf_counter() - t0
        manifest = durable.read_manifest(gen)
        if db.fin is not fin or db._wal is None or manifest["delta_version"] != db.delta_version:
            raise AssertionError("the snapshot replaced the live fin or armed no WAL")

        # -- two commits with the WAL armed, each after a timed gc.collect()
        # and split into the parse into the host store, the one add of it
        # that frees the host Finalized the snapshot left cached, the WAL
        # append, and the collector's pauses inside the commit
        armed_ms, armed_parts, armed_atoms = [], [], 0
        for k in range(2):
            nodes, links, new, _partners = gene_commit(
                rng, ref, name_of, f"GENE:durable{k}_", 256, commit["with_procs"],
                commit["procs"])
            total, version = db._delta_total, db.delta_version
            parts = {"snapshot_fin_cached": das.data._fin is not None}
            t0 = time.perf_counter()
            gc.collect()
            parts["gc_collect_before_ms"] = (time.perf_counter() - t0) * 1e3
            sink = {}
            torch.cuda.synchronize()
            with Timed(sink, atom_table, "load_metta_text"), \
                    Timed(sink, durable.DeltaLog, "append"), \
                    FinRelease(das.data) as freed, GcPauses() as pauses:
                t0 = time.perf_counter()
                das.commit_transaction(transaction(das, nodes, links))
                torch.cuda.synchronize()
                armed_ms.append((time.perf_counter() - t0) * 1e3)
            parts.update({
                "parse_ms": sink["load_metta_text"] * 1e3,
                "fin_release_ms": freed.ms,
                "wal_append_ms": sink["append"] * 1e3,
                "wal_share": sink["append"] * 1e3 / armed_ms[-1],
                "refresh_rest_ms": armed_ms[-1] - (sink["load_metta_text"] + sink["append"]) * 1e3,
                "gc_pause_ms": pauses.ms, "gc_collections": pauses.by_gen})
            armed_parts.append(parts)
            ref.record(db, links)
            armed_atoms += 256 + len(links)
            name_of.update((db.get_node_handle("Gene", n), n) for n in new)
            if (db.delta_version != version + 1 or db._delta_total != total + 256 + len(links)
                    or db.fin is not fin):
                raise AssertionError("an armed commit was not incremental into the live fin")
        wal_path = os.path.join(gen, durable.WAL_FILE)
        wal_records, torn = durable.read_wal(wal_path, truncate=False)
        if torn or [r["v"] for r in wal_records] != [db.delta_version - 1, db.delta_version]:
            raise AssertionError("the WAL does not hold the two armed commits")
        families = durable_families(args, data, host, ref, name_of)
        dead, _ = family_answers(das, families)
        for fam, queries in families.items():
            if dead[fam] != [want for _q, want in queries]:
                raise AssertionError(f"the live store's {fam} answers differ from numpy")
        dead_version = db.delta_version

        # -- drop the store, restore it ---------------------------------------------
        torch.cuda.synchronize()
        mem_live = torch.cuda.memory_allocated()
        del das, db
        gc.collect()
        torch.cuda.empty_cache()
        mem_dropped = torch.cuda.memory_allocated()
        restore_parts = {}
        with Timed(restore_parts, durable, "verify_generation"), \
                Timed(restore_parts, durable, "decode"), \
                Timed(restore_parts, checkpoint, "_restore_records"), \
                Timed(restore_parts, checkpoint, "_restore_indexes"), \
                Timed(restore_parts, durable, "replay_wal"):
            t0 = time.perf_counter()
            rdas = DistributedAtomSpace(backend="tensor", device=DEVICE,
                                        config=DasConfig(snapshot_dir=root))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        rdb = rdas.db
        # the generation is a fresh finalize, so the restored store's overlay
        # holds the two replayed commits only
        on_device = rdb.dev.buckets[2].rows.device.type == torch.device(DEVICE).type
        if (durable.DUR_STATS["recovery_replayed"] != 2 or rdb.delta_version != dead_version
                or rdb._delta_total != armed_atoms or not on_device):
            raise AssertionError(
                f"restore: replayed {durable.DUR_STATS['recovery_replayed']}, delta_version "
                f"{rdb.delta_version} / {dead_version}, _delta_total {rdb._delta_total} / "
                f"{armed_atoms}")
        torch.cuda.synchronize()
        compiler.reset_route_counts()
        reset_launch_counts()
        f0 = fused.FETCH_COUNTS["n"]
        t0 = time.perf_counter()
        got, stars_routed = family_answers(rdas, families)
        families_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(LAUNCH_COUNTS)
        routes = dict(compiler.ROUTE_COUNTS)
        fetches = fused.FETCH_COUNTS["n"] - f0
        for fam in families:
            if got[fam] != dead[fam]:
                raise AssertionError(f"the restored store's {fam} answers differ")
        idle = [k for k in TPU_KERNELS if launches[k] == 0]
        if idle or routes["host"]:
            raise AssertionError(f"restored store: kernels idle {idle}, routes {routes}")
        answers = {fam: sum(len(a) for a in v) for fam, v in got.items()}
        del rdas, rdb
        gc.collect()
        torch.cuda.empty_cache()

        small = durable_small(args, root)
        emit({
            "phase": "durable", "card": smi, "scale": args.scale,
            "disk_free_bytes": disk.free,
            "snapshot_s": snapshot_s, "snapshot_parts_s": snap_parts,
            "section_bytes": {n: m["bytes"] for n, m in manifest["sections"].items()},
            "armed_commit_ms": armed_ms, "armed_commit_parts": armed_parts,
            "unarmed_commit_ms_p50": commit["commit_ms_p50"],
            "wal_bytes": os.path.getsize(wal_path), "wal_records": len(wal_records),
            "restore_s": restore_s, "restore_parts_s": restore_parts,
            "kb_build_s": kb["build_s"],
            "kb_finalize_upload_s": kb["finalize_upload_s"],
            "kb_build_plus_upload_s": kb["build_s"] + kb["finalize_upload_s"],
            "replayed": 2, "delta_version": dead_version, "restored_delta_total": armed_atoms,
            "device_bytes": {"live": mem_live, "dropped": mem_dropped},
            "families_s": families_s, "answers": answers, "host_fetches": fetches,
            "stars_multiway_auto": stars_routed, "routes": routes, "launches": launches,
            "small": small, "phase_s": time.perf_counter() - t_phase,
        })
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def durable_small(args, root):
    """On SMALL: attach at construction, commit twice, drop and restore
    (every table bit-equal to the dead store's), a torn WAL tail, a
    corrupt section of a newer generation, and the warm bundle applied at
    its version and discarded past it, with first-pass rounds."""
    import gc

    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.storage import checkpoint, durable

    rng = random.Random(args.seed + 12)
    sdata, sgenes = build_kb(SMALL, args.seed)
    shost = HostKB(sdata, sgenes)
    sref = CommitRef(shost)
    sprocs = sorted({sref.hexes[p] for p in shost.member[:, 1].tolist()})
    sname = {h: sdata.nodes[h].name for h in sref.hexes[:len(sdata.nodes)]}
    sexisting = sorted({sref.hexes[g] for g in shost.member[:, 0].tolist()})
    sroot = os.path.join(root, "small")
    cfg = lambda **kw: DasConfig(snapshot_dir=sroot, **kw)
    sdas = DistributedAtomSpace(backend="tensor", data=sdata, device=DEVICE, config=cfg())
    new = []
    for k in range(2):
        nodes, links, names, _p = gene_commit(rng, sref, sname, f"GENE:sdur{k}_", 16, sexisting,
                                              sprocs)
        sdas.commit_transaction(transaction(sdas, nodes, links))
        new += names
    queries = [grounded_query(g, negate) for g in new[:4] + [sname[h] for h in sexisting[:4]]
               for negate in (False, True)]
    want = [answer_handles(sdas, q) for q in queries]
    if not any(want):
        raise AssertionError("SMALL: every answer is empty")
    tables = host_tables(sdas.db)
    version = sdas.db.delta_version
    del sdas
    gc.collect()

    def restore(what, expect):
        durable.reset_stats()
        r = DistributedAtomSpace(backend="tensor", device=DEVICE, config=cfg())
        stats = durable.snapshot_stats()
        for k, v in expect.items():
            if stats[k] != v:
                raise AssertionError(f"SMALL {what}: {k} {stats[k]}, expected {v}")
        if r.db.delta_version != version:
            raise AssertionError(f"SMALL {what}: delta_version {r.db.delta_version} != {version}")
        n = assert_same_tables(tables, host_tables(r.db), f"SMALL {what}")
        if [answer_handles(r, q) for q in queries] != want:
            raise AssertionError(f"SMALL {what}: answers differ from the dead store's")
        return r, n

    r1, n_arrays = restore("restore", {"recovery_replayed": 2})
    gen1 = durable.list_generations(os.path.join(sroot, r1.database_name))[-1][1]
    wal = os.path.join(gen1, durable.WAL_FILE)
    clean = os.path.getsize(wal)
    with open(wal, "ab") as f:       # half a frame: a crash mid-append
        frame = durable._WAL_HEADER.pack(durable.WAL_MAGIC, 4096, 0) + b"\0" * 2048
        f.write(frame[:len(frame) // 2])
    r2, _ = restore("torn tail", {"recovery_replayed": 2, "torn_tail_truncations": 1})
    if os.path.getsize(wal) != clean:
        raise AssertionError("SMALL: the torn tail was not cut back to the last frame")
    gen2 = r2.save_snapshot()
    path = os.path.join(gen2, checkpoint.RECORDS_FILE)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    restore("corrupt section", {"recovery_replayed": 2, "corrupt_generations": 1})
    del r1, r2

    # the warm bundle: the planner off, so the blind seeds miss and retry
    wroot = os.path.join(root, "small_warm")
    wcfg = lambda: DasConfig(snapshot_dir=wroot, use_planner="off")
    wdata, wgenes = build_kb(SMALL, args.seed)
    wdas = DistributedAtomSpace(backend="tensor", data=wdata, device=DEVICE, config=wcfg())
    procs = sorted(r.name for r in wdata.nodes.values() if r.named_type == "BiologicalProcess")
    gnames = [wdata.nodes[h].name for h in wgenes]
    wq = [fanout_star_query(p) for p in procs[:8]] + [grounded_query(g) for g in gnames[:8]]

    def first_pass(d):
        with ConjRounds() as rounds:
            got = [answer_set(d, q) for q in wq]
        return rounds.n, got

    live_rounds, wwant = first_pass(wdas)
    if live_rounds <= len(wq):
        raise AssertionError("SMALL warm: the blind seeds retried no query")
    wgen = wdas.save_snapshot()
    with_bundle = DistributedAtomSpace(backend="tensor", device=DEVICE, config=wcfg())
    rounds_with, got = first_pass(with_bundle)
    without = DistributedAtomSpace(backend="tensor", device=DEVICE,
                                   data=checkpoint.load(wgen, _verified=True),
                                   config=DasConfig(use_planner="off"))
    rounds_without, got2 = first_pass(without)
    if got != wwant or got2 != wwant or rounds_with != len(wq) or rounds_without != live_rounds:
        raise AssertionError(f"SMALL warm: rounds {rounds_with} with the bundle, "
                             f"{rounds_without} without, {live_rounds} live")
    g0 = gnames[0]
    with_bundle.commit_transaction(transaction(
        with_bundle, {g0: "Gene", "GENE:warm_new": "Gene", procs[0]: "BiologicalProcess"},
        [("Member", "GENE:warm_new", procs[0]), ("Interacts", "GENE:warm_new", g0)]))
    stale = DistributedAtomSpace(backend="tensor", device=DEVICE, config=wcfg())
    from das_tpu_torch.query.fused import get_executor

    if get_executor(stale.db)._cap_store._data or stale.db.delta_version != \
            with_bundle.db.delta_version:
        raise AssertionError("SMALL warm: a bundle older than the store was applied")
    rounds_stale, _ = first_pass(stale)
    torch.cuda.synchronize()
    return {"arrays_bit_equal": n_arrays, "delta_version": version,
            "torn_tail_cut_to": clean, "warm": {
                "queries": len(wq), "live_rounds": live_rounds,
                "restored_with_bundle_rounds": rounds_with,
                "restored_without_bundle_rounds": rounds_without,
                "restored_past_bundle_rounds": rounds_stale}}


# ---- phase 13 --------------------------------------------------------------------


class RssPeak:
    """While active, samples this process's resident set every 20 ms from
    /proc/self/statm (read only): `peak` and `before` in bytes."""

    def __enter__(self):
        import threading

        self.before = self.peak = self.read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def read():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.read())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.read())
        return False


def hex_block(hexes):
    """[n, 16] uint8 digests of an iterable of hex handles."""
    return np.frombuffer(bytes.fromhex("".join(hexes)), dtype=np.uint8).reshape(-1, 16)


def row_digests(hex_of_row):
    """[rows, 16] digests of a Finalized's row registry: the lazy registry
    of a columnar store (storage/columnar.py LazyHexRows) keeps them as an
    array already, with a list tail for rows interned by commits."""
    from das_tpu_torch.storage.columnar import LazyHexRows

    if isinstance(hex_of_row, LazyHexRows):
        tail = hex_block(hex_of_row._tail) if hex_of_row._tail else np.empty((0, 16), np.uint8)
        return np.concatenate([hex_of_row._base, tail])
    return hex_block(hex_of_row)


def sorted_digests(block):
    """The rows of an [n, 16] digest array in one canonical order."""
    keys = np.ascontiguousarray(block).view(">u8").reshape(-1, 2)
    return block[np.lexsort((keys[:, 1], keys[:, 0]))]


def assert_same_finalized(want, got):
    """Raise unless two Finalized are equal bit for bit: the row registry
    (compared as digests), the type registry, every bucket column, posting
    key and permutation, the incoming CSR and the dangling set."""
    if (want.atom_count, want.node_count) != (got.atom_count, got.node_count):
        raise AssertionError("finalize: atom counts differ")
    if not np.array_equal(row_digests(want.hex_of_row), row_digests(got.hex_of_row)):
        raise AssertionError("finalize: the row registries differ")
    if want.type_names != got.type_names or want.type_id_of_hash != got.type_id_of_hash:
        raise AssertionError("finalize: the type registries differ")
    pairs = [(f"{n}", getattr(want, n), getattr(got, n))
             for n in ("node_type_id", "incoming_offsets", "incoming_links")]
    if sorted(want.buckets) != sorted(got.buckets):
        raise AssertionError("finalize: the bucket arities differ")
    for arity, wb in want.buckets.items():
        gb = got.buckets[arity]
        for n in ("rows", "type_id", "ctype", "targets", "targets_sorted", "order_by_type",
                  "key_type", "order_by_ctype", "key_ctype"):
            pairs.append((f"b{arity}.{n}", getattr(wb, n), getattr(gb, n)))
        for n in ("order_by_type_pos", "key_type_pos", "order_by_pos", "key_pos",
                  "order_by_type_spos", "key_type_spos"):
            ws, gs = getattr(wb, n), getattr(gb, n)
            if len(ws) != len(gs):
                raise AssertionError(f"finalize: b{arity}.{n} lengths differ")
            pairs += [(f"b{arity}.{n}[{i}]", w, g) for i, (w, g) in enumerate(zip(ws, gs))]
    for name, w, g in pairs:
        if w.dtype != g.dtype or w.shape != g.shape or not np.array_equal(w, g):
            raise AssertionError(f"finalize: {name} differs")
    if want.dangling_hexes != got.dangling_hexes:
        raise AssertionError("finalize: the dangling sets differ")
    return len(pairs)


def assert_same_device_tables(want, got):
    """Raise unless two DeviceTables hold equal tensors (dtype, shape,
    values, sizes and capacities), compared one tensor at a time on the
    host; returns the number of tensors compared."""
    from das_tpu_torch.storage.tensor_db import BUCKET_LIST_PADS, BUCKET_PADS

    pairs = [(n, getattr(want, n), getattr(got, n))
             for n in ("node_type_id", "incoming_offsets", "incoming_links")]
    if sorted(want.buckets) != sorted(got.buckets):
        raise AssertionError("device tables: the bucket arities differ")
    for arity, wb in want.buckets.items():
        gb = got.buckets[arity]
        if (wb.size, wb.capacity) != (gb.size, gb.capacity):
            raise AssertionError(f"device tables: b{arity} size or capacity differs")
        pairs += [(f"b{arity}.{n}", getattr(wb, n), getattr(gb, n)) for n, _ in BUCKET_PADS]
        for n, _ in BUCKET_LIST_PADS:
            pairs += [(f"b{arity}.{n}[{i}]", w, g)
                      for i, (w, g) in enumerate(zip(getattr(wb, n), getattr(gb, n)))]
    for name, w, g in pairs:
        w, g = w.cpu(), g.cpu()
        if w.dtype != g.dtype or w.shape != g.shape or not bool((w == g).all()):
            raise AssertionError(f"device tables: {name} differs")
    return len(pairs)


def ingest_families(args, data, host, ref, name_of, new=()):
    """Phase durable's families on an ingested store (phase slice's grounded
    and Not queries, phase planned's grounded stars, 4 of phase tree's Ors
    of two chains), plus the grounded and Not queries of `new` genes, each
    with its numpy answer in handle space from `ref`."""
    families = durable_families(args, data, host, ref, name_of)
    families["or2"] = families["or2"][:4]
    handle = {n: h for h, n in name_of.items()}
    families["new_genes"] = [(grounded_query(n, neg), ref.grounded(handle[n], neg))
                             for n in new for neg in (False, True)]
    return families


def phase_ingest(args, data, base, genes, host, smi):
    """Bulk ingest on the card: the FlyBase-shaped KB written as a canonical
    file at --scale and --seed, loaded by the facade through the native
    scanner's columnar route, timed by stage (generation, the scan into
    columns, finalize plus upload); checked against the in-process build of
    the same configuration (`base` = its node and link counts, a prefix of
    `data`'s insertion-ordered records): handle sets, the Finalized bit for
    bit, and the device tables against an upload of the dict finalize.
    Then phase durable's families on the ingested store, a commit, the
    families again, and the animals KB dumped to canonical form and loaded
    through the columnar route against load_knowledge_base of the .metta
    file.  Counters zeroed just before the ingested store's queries, read
    just after the last of them."""
    import gc
    import resource
    import shutil
    import tempfile
    from itertools import islice

    import torch

    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.convert.dump import write_canonical
    from das_tpu_torch.ingest import native
    from das_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from das_tpu_torch.models.bio import write_bio_canonical
    from das_tpu_torch.query import compiler, fused
    from das_tpu_torch.storage import columnar
    from das_tpu_torch.storage import atom_table
    from das_tpu_torch.storage.atom_table import AtomSpaceData, load_metta_file
    from das_tpu_torch.storage.tensor_db import DeviceTables

    t_phase = time.perf_counter()
    cfg = scaled(FLYBASE, args.scale)
    root = tempfile.mkdtemp(prefix="das_ingest_")
    try:
        path = os.path.join(root, "flybase_shaped.metta")
        with RssPeak() as gen_rss:
            t0 = time.perf_counter()
            n_expr = write_bio_canonical(path, seed=args.seed, **cfg)
            generate_s = time.perf_counter() - t0
        file_mb = os.path.getsize(path) / 1e6
        # the scanner's build is timed apart from the load; in a whole run
        # phase entry has built it already (`scanner_prebuilt` true), and
        # its own `cli.scanner_build_s` holds the g++ run
        prebuilt = (native.BUILD_DIR / f"libdas_native_{native._digest()}.so").exists()
        t0 = time.perf_counter()
        native.build()
        scanner_build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        parts = {}
        das = DistributedAtomSpace(backend="tensor", device=DEVICE)
        with RssPeak() as load_rss, \
                Timed(parts, native, "load_canonical_files_columnar"), \
                Timed(parts, columnar, "columnar_finalize"):
            t0 = time.perf_counter()
            das.load_canonical_knowledge_base(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        store_bytes = torch.cuda.memory_allocated() - mem0
        scan_s = parts["load_canonical_files_columnar"]
        finalize_s = parts["columnar_finalize"]
        core = das.data.columnar
        if core is None or das.db.dev.buckets[2].rows.device.type != torch.device(DEVICE).type:
            raise AssertionError("the canonical load did not take the columnar route to the card")
        if das.count_atoms() != base:
            raise AssertionError(f"ingested {das.count_atoms()} atoms, built {base}")

        # -- against the in-process build --------------------------------------------
        t0 = time.perf_counter()
        n0, m0 = base
        for what, block, hexes in (("node", core.node_hash, islice(data.nodes, n0)),
                                   ("link", core.link_hash, islice(data.links, m0))):
            if not np.array_equal(sorted_digests(block), sorted_digests(hex_block(hexes))):
                raise AssertionError(f"the ingested {what} handles differ from the build's")
        if host.fin.atom_count == n0 + m0:
            ref_fin = host.fin          # nothing was committed to the build
        else:
            ref_data = AtomSpaceData()
            ref_data.nodes = dict(islice(data.nodes.items(), n0))
            ref_data.links = dict(islice(data.links.items(), m0))
            ref_fin = ref_data.finalize()
            del ref_data
        n_fin = assert_same_finalized(ref_fin, das.db.fin)
        ref_tables = DeviceTables(ref_fin, torch.device("cpu"))
        n_tables = assert_same_device_tables(ref_tables, das.db.dev)
        del ref_tables, ref_fin
        check_s = time.perf_counter() - t0
        spent = {}                # the phase's other seconds, by part
        t0 = time.perf_counter()
        gc.collect()
        spent["gc_s"] = time.perf_counter() - t0

        # -- queries, a commit, queries again ----------------------------------------
        ref = CommitRef(host)
        name_of = {h: data.nodes[h].name for h in genes}
        procs = sorted({ref.hexes[p] for p in host.member[:, 1].tolist()})
        name_of.update((p, data.nodes[p].name) for p in procs)
        with_procs = sorted({ref.hexes[g] for g in host.member[:, 0].tolist()})
        t0 = time.perf_counter()
        families = ingest_families(args, data, host, ref, name_of)
        spent["numpy_answers_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        compiler.reset_route_counts()
        reset_launch_counts()
        f0 = fused.FETCH_COUNTS["n"]
        t0 = time.perf_counter()
        got, stars_routed = family_answers(das, families)
        families_s = time.perf_counter() - t0
        for fam, queries in families.items():
            if got[fam] != [want for _q, want in queries]:
                raise AssertionError(f"ingested store: {fam} answers differ from numpy")
        answers = {fam: sum(len(a) for a in v) for fam, v in got.items()}
        db = das.db
        version, total = db.delta_version, db._delta_total
        nodes, links, new, _partners = gene_commit(
            random.Random(args.seed + 13), ref, name_of, "GENE:ingest_", 256, with_procs, procs)
        # the commit split: the parse with its membership probes (linear
        # scans of the digest columns while no digest index exists, else
        # the sorted index), the device merge, the collector's pauses
        sink = {}
        torch.cuda.synchronize()
        with Timed(sink, atom_table, "load_metta_text"), \
                Timed(sink, columnar, "_linear_find") as linear, \
                Timed(sink, columnar._DigestIndex, "find") as indexed, \
                Timed(sink, columnar.ColumnarCore, "wait_indexes"), \
                Timed(sink, type(db), "_stage_delta_merge"), GcPauses() as pauses:
            t0 = time.perf_counter()
            das.commit_transaction(transaction(das, nodes, links))
            torch.cuda.synchronize()
            commit_ms = (time.perf_counter() - t0) * 1e3
        commit_parts = {
            "parse_ms": sink["load_metta_text"] * 1e3,
            "linear_probes": linear.n, "linear_probe_ms": sink.get("_linear_find", 0.0) * 1e3,
            "indexed_probes": indexed.n, "indexed_probe_ms": sink.get("find", 0.0) * 1e3,
            "wait_indexes_ms": sink.get("wait_indexes", 0.0) * 1e3,
            "merge_ms": sink["_stage_delta_merge"] * 1e3,
            "rest_ms": commit_ms - (sink["load_metta_text"] + sink["_stage_delta_merge"]) * 1e3,
            "gc_pause_ms": pauses.ms, "gc_collections": pauses.by_gen}
        if (db.delta_version != version + 1 or db._delta_total != total + 256 + len(links)
                or das.data.columnar is not core):
            raise AssertionError("the commit onto the columnar store was not incremental")
        ref.record(db, links)
        name_of.update((db.get_node_handle("Gene", n), n) for n in new)
        t0 = time.perf_counter()
        families = ingest_families(args, data, host, ref, name_of, new[:16])
        spent["numpy_answers_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        after, _ = family_answers(das, families)
        spent["after_commit_families_s"] = time.perf_counter() - t0
        for fam, queries in families.items():
            if after[fam] != [want for _q, want in queries]:
                raise AssertionError(f"ingested store after the commit: {fam} answers differ")
        if not any(after["new_genes"][0::2]):
            raise AssertionError("no new gene's grounded answer is non-empty")
        torch.cuda.synchronize()
        launches = dict(LAUNCH_COUNTS)
        routes = dict(compiler.ROUTE_COUNTS)
        fetches = fused.FETCH_COUNTS["n"] - f0
        idle = [k for k in TPU_KERNELS if launches[k] == 0]
        if idle or routes["host"]:
            raise AssertionError(f"ingested store: kernels idle {idle}, routes {routes}")
        after_answers = {fam: sum(len(a) for a in v) for fam, v in after.items()}
        del das, db, core
        t0 = time.perf_counter()
        gc.collect()
        spent["gc_s"] += time.perf_counter() - t0
        torch.cuda.empty_cache()

        # -- animals: dumped to canonical form, loaded through the columnar route -----
        animals_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "data", "samples", "animals.metta")
        canonical_path = os.path.join(root, "animals_canonical.metta")
        t0 = time.perf_counter()
        write_canonical(load_metta_file(animals_path), canonical_path)
        cdas = DistributedAtomSpace(backend="tensor", device=DEVICE)
        cdas.load_canonical_knowledge_base(canonical_path)
        mdas = DistributedAtomSpace(backend="tensor", device=DEVICE)
        mdas.load_knowledge_base(animals_path)
        if cdas.data.columnar is None or cdas.count_atoms() != mdas.count_atoms():
            raise AssertionError("animals: the canonical dump did not load columnar, or lost atoms")
        reset_launch_counts()
        animal_answers = 0
        for q in animal_queries():
            want = tree_answer(mdas, q, str)
            if tree_answer(cdas, q, str) != want:
                raise AssertionError(f"animals: {q} differs between the canonical and .metta loads")
            animal_answers += len(want[2])
        for k in TPU_KERNELS:
            launches[k] += LAUNCH_COUNTS[k]
        del cdas, mdas
        spent["animals_s"] = time.perf_counter() - t0

        finalize_upload_s = load_s - scan_s
        emit({
            "phase": "ingest", "card": smi, "scale": args.scale, "seed": args.seed,
            "expressions": n_expr, "file_mb": file_mb, "nodes": base[0], "links": base[1],
            "scanner_build_s": scanner_build_s, "scanner_prebuilt": prebuilt,
            "generate_s": generate_s, "scan_s": scan_s, "finalize_s": finalize_s,
            "upload_s": finalize_upload_s - finalize_s,
            "finalize_upload_s": finalize_upload_s, "load_s": load_s,
            "scan_mb_per_s": file_mb / scan_s, "load_mb_per_s": file_mb / load_s,
            "load_expressions_per_s": n_expr / load_s,
            "rss_bytes": {"before_generate": gen_rss.before, "peak_generate": gen_rss.peak,
                          "before_load": load_rss.before, "peak_load": load_rss.peak,
                          "load_increase": load_rss.peak - load_rss.before,
                          "process_peak_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss},
            "store_bytes_allocated": store_bytes,
            "checks": {"finalized_arrays": n_fin, "device_tables": n_tables,
                       "check_s": check_s},
            "families_s": families_s, "answers": answers, "after_commit_answers": after_answers,
            "stars_multiway_auto": stars_routed, "commit_ms": commit_ms,
            "commit_parts": commit_parts, "spent": spent,
            "routes": routes, "host_fetches": fetches,
            "animals": {"queries": len(animal_queries()), "answers": animal_answers},
            "launches": launches, "phase_s": time.perf_counter() - t_phase,
        })
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="fraction of the FlyBase-shaped KB's counts (widths are never cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50, help="timed calls per kernel case")
    ap.add_argument("--only-sharded", action="store_true",
                    help="phases card, kb and sharded alone (no kernels line)")
    ap.add_argument("--only-ingest", action="store_true",
                    help="phases card and ingest alone (no kernels line): the full-scale "
                         "ingest measurement")
    ap.add_argument("--only-multiprocess", action="store_true",
                    help="phases card, kb and multiprocess alone (no kernels line)")
    ap.add_argument("--only-ontology", action="store_true",
                    help="phases card and ontology alone (no kernels line)")
    ap.add_argument("--only-programs", action="store_true",
                    help="phases card, kb and programs alone (no kernels line)")
    # one rank of phase multiprocess (the phase starts these itself)
    ap.add_argument("--multiprocess-child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    if args.multiprocess_child is not None:
        return multiprocess_child(args)

    def done():
        emit({"elapsed_s": time.perf_counter() - t_start})
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    t_start = time.perf_counter()
    smi = phase_card()
    if args.only_ontology:
        phase_ontology(args, smi)
        return done()

    cfg = scaled(FLYBASE, args.scale)
    t0 = time.perf_counter()
    data, genes = build_kb(cfg, args.seed)
    build_s = time.perf_counter() - t0
    base = (len(data.nodes), len(data.links))
    if args.only_ingest:
        emit({"phase": "kb", "scale": args.scale, "nodes": base[0], "links": base[1],
              "build_s": build_s})
        phase_ingest(args, data, base, genes, HostKB(data, genes), smi)
        return done()
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
    families = star_families(args, data, genes, host, das)
    if args.only_sharded:
        phase_sharded(args, das, data, genes, host, families, (ldas, ldata, lgenes), smi)
        return done()
    if args.only_multiprocess:
        phase_multiprocess(args, das, data, host, {}, smi)
        return done()
    if args.only_programs:
        phase_programs(args, das, data, genes, host, families, (ldas, ldata, lgenes), smi)
        return done()
    timing = phase_kernels(das, main_gene, families["grounded_star"][0][0],
                           families["fanout_star"][0][0], args.iters)
    launches, slice_p50 = phase_slice(args, das, data, genes, (ldas, ldata, lgenes), small)
    serving = phase_serving(args, das, data, genes, host, smi, slice_p50)
    for name in ("probe", "index_join", "join_tables", "anti_join"):
        launches[name] += serving[name]
    launches["multiway"] = phase_planned(das, families)["multiway"]
    counted = phase_count_batch(args, das, data, genes, host)
    api = phase_api(args, das, data, genes, host, families, smi)
    tree = phase_tree(args, das, data, genes, host, (ldas, ldata, lgenes), smi)
    entry = phase_entry(args, das, data, host, smi)
    sharded = phase_sharded(args, das, data, genes, host, families, (ldas, ldata, lgenes), smi)
    # the ontology KB is built on the host while the multiprocess children
    # build theirs
    multi, onto_kb = phase_multiprocess(args, das, data, host, sharded, smi,
                                        meanwhile=lambda: ontology_kb(args))
    onto = phase_ontology(args, smi, onto_kb)
    del onto_kb
    programs = phase_programs(args, das, data, genes, host, families, (ldas, ldata, lgenes), smi)
    commit, committed = phase_commit(args, das, data, genes, host, smi, upload_s, slice_p50)
    mined = phase_miner(args, das, smi)
    served = phase_service(args, das, data, genes, host, smi)
    # the durable phase drops the store: this frame keeps no reference to it
    holder = {"das": das}
    del das
    durable = phase_durable(args, holder, data, genes, host, smi,
                            {"build_s": build_s, "finalize_upload_s": upload_s}, committed)
    ingested = phase_ingest(args, data, base, genes, host, smi)
    for name in TPU_KERNELS:
        launches[name] += (counted[name] + api[name] + tree[name] + entry[name] + sharded[name]
                           + multi[name]
                           + onto[name] + programs[name] + commit[name] + mined[name]
                           + served[name] + durable[name] + ingested[name])

    kernels_line = []
    for name, (source, replaces) in TPU_KERNELS.items():
        t = timing[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    emit({"kernels": kernels_line})
    return done()


if __name__ == "__main__":
    sys.exit(main())
