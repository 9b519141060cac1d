"""Member($V1, p1), Member($V1, p2), Interacts(g, $V1): g's partners in
both processes.  As the service smoke builds it: g has a partner x, and
p1, p2 are x's two highest-numbered processes, so x is an answer."""

import numpy as np

from dasbench.reference import _bio

VARS = ("$V1",)


def _first_last_two(pairs: np.ndarray, count: int):
    """Per source node: its smallest target, and its two largest (the
    largest twice when it has one); -1 where it has none."""
    span = int(pairs[:, 1].max()) + 1 if len(pairs) else 1
    key = np.sort(pairs[:, 0] * span + pairs[:, 1])
    a, b = key // span, key % span
    lo = np.searchsorted(a, np.arange(count), "left")
    hi = np.searchsorted(a, np.arange(count), "right")
    has = hi > lo
    first = np.where(has, b[np.minimum(lo, len(b) - 1)], -1)
    last = np.where(has, b[np.maximum(hi - 1, 0)], -1)
    second = np.where(hi - lo > 1, b[np.maximum(hi - 2, 0)], last)
    return first, second, last


def draw(kb, ix, rng, n):
    pool = _bio.served_genes(ix)
    g = pool[rng.integers(0, len(pool), size=n)]
    count = kb.nodes[_bio.GENE].count
    x, _, _ = _first_last_two(ix.narrow(kb.pairs("Interacts", _bio.GENE, _bio.GENE)), count)
    _, p1, p2 = _first_last_two(ix.narrow(kb.pairs("Member", _bio.GENE, _bio.PROC)), count)
    xs = x[g]
    return np.stack([g, p1[xs], p2[xs]], axis=1)


def dsl(kb, p):
    g = _bio.name(kb, _bio.GENE, p[0])
    p1, p2 = (_bio.name(kb, _bio.PROC, q) for q in p[1:])
    return (f"Node p1 BiologicalProcess {p1}, Node p2 BiologicalProcess {p2}, "
            f"Node g Gene {g}, Link Member $V1 p1, Link Member $V1 p2, "
            f"Link Interacts g $V1, AND")


def answer(ix, p):
    """Folded: every term has links (p1 and p2 hold x, g has x as a
    partner), and the first join holds x, so no term re-seeds."""
    both = np.intersect1d(_bio.members(ix, p[1]), _bio.members(ix, p[2]))
    return _bio.rows((_bio.GENE, np.intersect1d(both, _bio.partners(ix, p[0]))))
