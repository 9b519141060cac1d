"""Member(g, $V3), Member($V2, $V3), Not Interacts(g, $V2): every gene that
shares a process with g and is not its partner (about 1,300 answers at
ten processes a gene); its genes are drawn as grounded.py draws them."""

from dasbench.reference import _bio, grounded

VARS = grounded.VARS
draw = grounded.draw


def dsl(kb, p):
    return grounded.dsl(kb, p, negate=True)


def answer(ix, p):
    return _bio.grounded_pairs(ix, p[0], negate=True)
