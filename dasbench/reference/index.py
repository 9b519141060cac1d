"""Sorted views of a KB's binary links, for the reference's lookups."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from dasbench.kb import KB


class LinkIndex:
    """`targets(link, src, dst, i)`: the `dst` nodes that `src` node `i`
    links to; `sources(...)`: the `src` nodes that link to `dst` node `i`.
    Each (link type, src type, dst type) is sorted once, on first use.

    With `bits`, every node index is taken modulo 2**bits on the way in
    and out: the control's narrowed id columns (check.py)."""

    def __init__(self, kb: KB, bits: int = 0):
        self.kb = kb
        self.mod = (1 << bits) if bits else 0
        self._sorted: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}

    def narrow(self, i):
        return i % self.mod if self.mod else i

    def _by(self, link: str, src: str, dst: str, col: int):
        key = (link, src, dst, col)
        hit = self._sorted.get(key)
        if hit is None:
            pairs = self.narrow(self.kb.pairs(link, src, dst))
            order = np.argsort(pairs[:, col], kind="stable")
            hit = self._sorted[key] = (pairs[order, col], pairs[order, 1 - col])
        return hit

    def targets(self, link: str, src: str, dst: str, i) -> np.ndarray:
        keys, other = self._by(link, src, dst, 0)
        i = self.narrow(int(i))
        return other[np.searchsorted(keys, i, "left"):np.searchsorted(keys, i, "right")]

    def sources(self, link: str, src: str, dst: str, i) -> np.ndarray:
        keys, other = self._by(link, src, dst, 1)
        i = self.narrow(int(i))
        return other[np.searchsorted(keys, i, "left"):np.searchsorted(keys, i, "right")]

    def with_targets(self, link: str, src: str, dst: str) -> np.ndarray:
        """The `src` nodes with at least one such link, ascending."""
        return np.unique(self._by(link, src, dst, 0)[0])
