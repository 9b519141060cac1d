"""The knowledge bases the benchmark makes, as NumPy arrays, and their
canonical MeTTa files.

A `KB` is typed nodes (a name template per type, numbered from 0) and
sets of links, each a link type over typed node columns.  A configuration's
generator (`dasbench/gen/<config>.py`) fills one from the seed; `write_canonical`
writes it in the converter format that the program's columnar loader reads
(types, then terminals, then one toplevel expression per line), building
the fixed-width lines as byte matrices rather than one string at a time.

This module and the reference (`dasbench/reference/`) read only these
arrays; nothing here imports the program.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Nodes:
    """`count` nodes of one type named `prefix` + the index zero-padded to
    `width` digits (no digits when `width` is 0)."""

    type: str
    count: int
    prefix: str
    width: int

    def name(self, i: int) -> str:
        return f"{self.prefix}{int(i):0{self.width}d}" if self.width else self.prefix


@dataclass
class Links:
    """Links of one type whose targets are, in order, nodes of
    `types[k]` numbered `columns[k]`.  With `wrap` = (outer type, (node
    type, index)), each link is nested as the second target of an outer
    link whose first target is that node: the FlyBase shape
    `Evaluation(Predicate, List(gene, process))`."""

    type: str
    types: Tuple[str, ...]
    columns: Tuple[np.ndarray, ...]
    wrap: Optional[Tuple[str, Tuple[str, int]]] = None

    def __len__(self) -> int:
        return int(self.columns[0].shape[0])


@dataclass
class KB:
    nodes: Dict[str, Nodes] = field(default_factory=dict)
    links: List[Links] = field(default_factory=list)

    def add_nodes(self, nodes: Nodes) -> None:
        self.nodes[nodes.type] = nodes

    def pairs(self, link_type: str, src: str, dst: str) -> np.ndarray:
        """[n, 2] int64 (source index, target index) of every binary link
        of `link_type` from `src` nodes to `dst` nodes."""
        parts = [np.stack(ls.columns, axis=1) for ls in self.links
                 if ls.type == link_type and ls.wrap is None and ls.types == (src, dst)]
        if not parts:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(parts).astype(np.int64, copy=False)

    def counts(self) -> Tuple[int, int]:
        """(nodes, links), nested links counted as links."""
        n_nodes = sum(n.count for n in self.nodes.values())
        n_links = sum(len(ls) * (2 if ls.wrap else 1) for ls in self.links)
        return n_nodes, n_links

    def link_types(self) -> List[str]:
        out = []
        for ls in self.links:
            for t in (ls.type, ls.wrap[0] if ls.wrap else None):
                if t and t not in out:
                    out.append(t)
        return out


def handle(node_type: str, name: str) -> str:
    """The atom handle of a node: md5 of "<type> <name>" (the reference
    hasher's terminal rule, frozen here)."""
    return hashlib.md5(f"{node_type} {name}".encode("utf-8")).hexdigest()


# -- the canonical file ------------------------------------------------------------


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """[n, width] uint8 ASCII digits of `values`, zero-padded."""
    v = values.astype(np.int32)[:, None]
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int32)[None, :]
    return ((v // powers) % 10 + 48).astype(np.uint8)


def _lines(parts, n: int) -> bytes:
    """`n` lines made of `parts`, each a bytes constant or a
    (values, width) digit column, as one block."""
    cols = []
    for p in parts:
        if isinstance(p, bytes):
            cols.append(np.broadcast_to(np.frombuffer(p, dtype=np.uint8), (n, len(p))))
        else:
            cols.append(_digits(*p))
    return np.concatenate(cols, axis=1).tobytes() if n else b""


def _ref_parts(nodes: Nodes, idx: np.ndarray):
    """The parts of `"<type> <name>"` for nodes `idx`."""
    head = f'"{nodes.type} {nodes.prefix}'.encode()
    return [head, (idx, nodes.width), b'"'] if nodes.width else [head + b'"']


def write_canonical(kb: KB, path: str) -> int:
    """Write `kb` to `path` in the canonical format; returns the number of
    expression lines."""
    lines = 0
    with open(path, "wb") as w:
        types = list(kb.nodes) + [t for t in kb.link_types() if t not in kb.nodes]
        for t in types:
            w.write(f"(: {t} Type)\n".encode())
        for nodes in kb.nodes.values():
            idx = np.arange(nodes.count, dtype=np.int64)
            head = f'(: "{nodes.prefix}'.encode()
            tail = f'" {nodes.type})\n'.encode()
            parts = [head, (idx, nodes.width), tail] if nodes.width else [head + tail]
            w.write(_lines(parts, len(idx)))
        for ls in kb.links:
            parts = [f"({ls.type}".encode()]
            if ls.wrap:
                outer, (ntype, i) = ls.wrap
                parts = [f'({outer} "{ntype} {kb.nodes[ntype].name(i)}" ({ls.type}'.encode()]
            for t, c in zip(ls.types, ls.columns):
                parts.append(b" ")
                parts += _ref_parts(kb.nodes[t], c)
            parts.append(b"))\n" if ls.wrap else b")\n")
            w.write(_lines(parts, len(ls)))
            lines += len(ls)
    return lines


# -- drawing helpers -----------------------------------------------------------------


def distinct_rows(rng: np.random.Generator, n_rows: int, k: int, high: int) -> np.ndarray:
    """[n_rows, k] int64: each row k distinct integers in [0, high), drawn
    uniformly; rows with a repeat are drawn again until none has one."""
    out = rng.integers(0, high, size=(n_rows, k), dtype=np.int64)
    while True:
        s = np.sort(out, axis=1)
        bad = np.nonzero((s[:, 1:] == s[:, :-1]).any(axis=1))[0]
        if not len(bad):
            return out
        out[bad] = rng.integers(0, high, size=(len(bad), k), dtype=np.int64)


def distinct_pairs(rng: np.random.Generator, n: int, high_a: int, high_b: int,
                   unordered: bool = False) -> np.ndarray:
    """[n, 2] int64 distinct pairs (a, b), a in [0, high_a), b in [0,
    high_b); with `unordered`, a != b and no pair appears in both
    orientations.  Draws again until n distinct pairs are found."""
    have = np.zeros((0, 2), dtype=np.int64)
    while len(have) < n:
        need = n - len(have)
        cand = np.stack([rng.integers(0, high_a, size=need + need // 8 + 16),
                         rng.integers(0, high_b, size=need + need // 8 + 16)], axis=1)
        if unordered:
            cand = cand[cand[:, 0] != cand[:, 1]]
            key_pairs = np.sort(cand, axis=1)
        else:
            key_pairs = cand
        merged = np.concatenate([have, cand])
        keys = np.concatenate([np.sort(have, axis=1) if unordered else have, key_pairs])
        code = keys[:, 0] * max(high_a, high_b) + keys[:, 1]
        _, first = np.unique(code, return_index=True)
        keep = np.sort(first)
        have = merged[keep][:n]
    return have
