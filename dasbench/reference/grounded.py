"""Member(g, $V3), Member($V2, $V3), Interacts(g, $V2): the processes of
gene g shared with its interaction partners."""

from dasbench.reference import _bio

VARS = ("$V2", "$V3")


def draw(kb, ix, rng, n):
    """[n, 1]: genes drawn uniformly from those with a Member and an
    Interacts link."""
    pool = _bio.served_genes(ix)
    return pool[rng.integers(0, len(pool), size=n)][:, None]


def dsl(kb, p, negate=False):
    return (f"Node g Gene {_bio.name(kb, _bio.GENE, p[0])}, Link Member g $V3, "
            f"Link Member $V2 $V3, Link Interacts g $V2{', NOT' if negate else ''}, AND")


def answer(ix, p):
    return _bio.grounded_pairs(ix, p[0], negate=False)
