"""Lookups the bio query families share.

An answer is a set of rows, one (node type, index) per variable of the
family's `VARS`.  A conjunction folds its terms in the order written, as
the upstream query engine does (and the program with it): a term with no
links at all empties the answer; a join that comes out empty leaves the
accumulator empty, and the next positive term then starts it afresh
("re-seeds" it); a Not term filters the accumulator."""

from __future__ import annotations

import numpy as np

GENE, PROC = "Gene", "BiologicalProcess"


def procs(ix, g) -> np.ndarray:
    return ix.targets("Member", GENE, PROC, g)


def members(ix, p) -> np.ndarray:
    return ix.sources("Member", GENE, PROC, p)


def partners(ix, g) -> np.ndarray:
    return ix.targets("Interacts", GENE, GENE, g)


def served_genes(ix) -> np.ndarray:
    """Genes with at least one Member and one Interacts link (worked out
    once per index)."""
    if getattr(ix, "served_genes", None) is None:
        ix.served_genes = np.intersect1d(ix.with_targets("Member", GENE, PROC),
                                         ix.with_targets("Interacts", GENE, GENE))
    return ix.served_genes


def name(kb, node_type, i) -> str:
    return kb.nodes[node_type].name(i)


def rows(*columns):
    """{((type, index), ...)} from (type, index array) columns of equal
    length."""
    lists = [[(t, i) for i in c.tolist()] for t, c in columns]
    return set(zip(*lists))


def two_genes(kb, rng, n) -> np.ndarray:
    """[n, 2] pairs of distinct genes drawn uniformly from all genes."""
    count = kb.nodes[GENE].count
    out = rng.integers(0, count, size=(n, 2), dtype=np.int64)
    while True:
        same = np.nonzero(out[:, 0] == out[:, 1])[0]
        if not len(same):
            return out
        out[same, 1] = rng.integers(0, count, size=len(same), dtype=np.int64)


def grounded_pairs(ix, g, negate: bool):
    """Member(g, V3), Member(V2, V3), [Not] Interacts(g, V2), folded: the
    first join holds (g, p) for each process p of g, so it is empty only
    when g has no process, and then so is the answer."""
    ps = procs(ix, g)
    part = partners(ix, g)
    if not len(ps) or (not negate and not len(part)):
        return set()
    ms = [members(ix, p) for p in ps.tolist()]
    v2 = np.concatenate(ms)
    v3 = np.repeat(ps, [len(m) for m in ms])
    keep = np.isin(v2, part) != negate
    return rows((GENE, v2[keep]), (PROC, v3[keep]))
