"""QUERY_1 of the upstream benchmark (`same_biological_process`, 2
genes): Member(g1, $V1), Member(g2, $V1), over genes drawn uniformly from
all genes, as upstream draws them; most pairs share no process."""

import numpy as np

from dasbench.reference import _bio

VARS = ("$V1",)


def draw(kb, ix, rng, n):
    return _bio.two_genes(kb, rng, n)


def dsl(kb, p):
    a, b = (_bio.name(kb, _bio.GENE, g) for g in p[:2])
    return f"Node a Gene {a}, Node b Gene {b}, Link Member a $V1, Link Member b $V1, AND"


def answer(ix, p):
    """Folded: the one join; empty when the genes share no process."""
    return _bio.rows((_bio.PROC, np.intersect1d(_bio.procs(ix, p[0]), _bio.procs(ix, p[1]))))
