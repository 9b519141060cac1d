"""The bio knowledge bases of the benchmark's configurations, drawn with
NumPy from the seed.

`flybase` is the FlyBase-shaped KB of the upstream SimplePatternMiner
notebook: genes and processes, `members_per_gene` distinct `Member` links
gene -> process per gene, `Interacts` between distinct gene pairs stored in
both orientations, and `Evaluation(Predicate, List(gene, process))`
links.

The schema and the names follow `das_tpu_torch/models/bio.py`
(`build_bio_atomspace`); the draws are the benchmark's own, vectorized,
and every pair is distinct, so the link counts are exact: a duplicate
drawn twice would be one atom in the store.
"""

from __future__ import annotations

import numpy as np

from dasbench.kb import KB, Links, Nodes, distinct_pairs, distinct_rows


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the seed (`stream` keeps the KB, the
    window's requests and the warm-up apart); any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream]))


def flybase(config: dict, seed: int) -> KB:
    rng = rng_for(seed, 1)
    n_genes, n_procs = int(config["n_genes"]), int(config["n_processes"])
    kb = KB()
    kb.add_nodes(Nodes("Gene", n_genes, "GENE:", 7))
    kb.add_nodes(Nodes("BiologicalProcess", n_procs, "GO:", 7))
    k = int(config["members_per_gene"])
    procs = distinct_rows(rng, n_genes, k, n_procs)
    genes = np.repeat(np.arange(n_genes, dtype=np.int64), k)
    kb.links.append(Links("Member", ("Gene", "BiologicalProcess"), (genes, procs.reshape(-1))))
    pairs = distinct_pairs(rng, int(config["n_interactions"]), n_genes, n_genes, unordered=True)
    a = np.concatenate([pairs[:, 0], pairs[:, 1]])
    b = np.concatenate([pairs[:, 1], pairs[:, 0]])
    kb.links.append(Links("Interacts", ("Gene", "Gene"), (a, b)))
    n_eval = int(config.get("n_evaluations", 0))
    if n_eval:
        kb.add_nodes(Nodes("Predicate", 1, "Predicate:has_name", 0))
        ev = distinct_pairs(rng, n_eval, n_genes, n_procs)
        kb.links.append(Links("List", ("Gene", "BiologicalProcess"), (ev[:, 0], ev[:, 1]),
                              wrap=("Evaluation", ("Predicate", 0))))
    return kb
