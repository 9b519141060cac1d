"""Synthetic bio-atomspace generator.

Stands in for the reference's gene-level bio atomspace
(scripts/benchmark.py:36-128 query shapes; SimplePatternMiner.ipynb scale)
so benchmarks are reproducible without the private FlyBase dump.  The graph
shape mirrors the benchmark's schema: Gene/BiologicalProcess/Reactome
nodes, ``Member`` links gene→process, ``Interacts`` gene↔gene (stored both
orientations like the animals KB's Similarity closure), and two-level
``Evaluation``/``List`` noise links exercising nested arities.

Atoms are built straight into `AtomSpaceData` records (no text round-trip)
so multi-million-atom KBs materialize in seconds.
"""

from __future__ import annotations

import random
from typing import Optional

from das_tpu_torch.core.expression import Expression
from das_tpu_torch.core.hashing import ExpressionHasher
from das_tpu_torch.core.schema import BASIC_TYPE, TYPEDEF_MARK
from das_tpu_torch.storage.atom_table import AtomSpaceData


def _add_type(data: AtomSpaceData, name: str) -> None:
    t = data.table
    mark_hash = t.get_named_type_hash(TYPEDEF_MARK)
    base_hash = t.get_named_type_hash(BASIC_TYPE)
    name_hash = t.get_named_type_hash(name)
    t.named_types[name] = BASIC_TYPE
    t.parent_type[name_hash] = base_hash
    elements = [name_hash, base_hash]
    expr = Expression(
        toplevel=True,
        typedef_name=name,
        typedef_name_hash=name_hash,
        named_type=TYPEDEF_MARK,
        named_type_hash=mark_hash,
        composite_type=[mark_hash, base_hash, base_hash],
        composite_type_hash=ExpressionHasher.composite_hash(
            [mark_hash, base_hash, base_hash]
        ),
        elements=elements,
        hash_code=ExpressionHasher.expression_hash(mark_hash, elements),
    )
    t.symbol_hash[name] = expr.hash_code
    data.add_typedef(expr)


def _add_node(data: AtomSpaceData, node_type: str, name: str) -> str:
    t = data.table
    type_hash = t.get_named_type_hash(node_type)
    h = t.get_terminal_hash(node_type, name)
    data.add_terminal(
        Expression(
            terminal_name=name,
            named_type=node_type,
            named_type_hash=type_hash,
            composite_type=[type_hash],
            composite_type_hash=type_hash,
            hash_code=h,
        )
    )
    return h


#: (link_type, element_ctypes) -> (type_hash, composite_type,
#: composite_type_hash).  Every value is a pure md5 function of the names,
#: so the memo needs no table identity; the composite-type hash is one md5
#: per link SCHEMA, not per link — at the 27.9M-link flybase scale
#: recomputing it per link doubled the generator's hashing work.
_LINK_SCHEMA_MEMO: dict = {}


def _link_schema(t, link_type: str, element_ctypes):
    # always exercised (not only on memo miss): registers the link type in
    # THIS table's name registry — the memo is shared across tables
    type_hash = t.get_named_type_hash(link_type)
    key = (link_type, tuple(
        c if isinstance(c, str) else tuple(c) for c in element_ctypes
    ))
    hit = _LINK_SCHEMA_MEMO.get(key)
    if hit is None:
        # memoize only immutable copies (the key's frozen tuples), never the
        # caller's list objects — a caller mutating its element_ctypes after
        # the first _add_link must not change what later lookups return
        composite_type = (type_hash, *key[1])
        cth = ExpressionHasher.composite_hash(
            [
                c if isinstance(c, str) else ExpressionHasher.composite_hash(list(c))
                for c in composite_type
            ]
        )
        hit = (type_hash, composite_type, cth)
        if len(_LINK_SCHEMA_MEMO) >= 1 << 16:  # bound the module-global memo
            _LINK_SCHEMA_MEMO.clear()
        _LINK_SCHEMA_MEMO[key] = hit
    # fresh (nested) list per link: records own their composite_type mutably
    composite = [list(c) if isinstance(c, tuple) else c for c in hit[1]]
    return hit[0], composite, hit[2]


def _add_link(data: AtomSpaceData, link_type: str, elements, element_ctypes) -> str:
    type_hash, composite_type, cth = _link_schema(
        data.table, link_type, element_ctypes
    )
    h = ExpressionHasher.expression_hash(type_hash, list(elements))
    data.add_link(
        Expression(
            toplevel=True,
            named_type=link_type,
            named_type_hash=type_hash,
            composite_type=composite_type,
            composite_type_hash=cth,
            elements=list(elements),
            hash_code=h,
        )
    )
    return h


def _skew_idx(rng: random.Random, n: int, skew: float) -> int:
    """One index draw.  skew == 0 is uniform (exactly one rng.randrange
    call, preserving historical draw sequences); skew > 0 maps a uniform
    u through u^(1+skew), concentrating mass on LOW indices — a power-law
    participation profile like real annotation datasets (FlyBase-style
    hub genes/processes), unlike the uniform synthetic KB (VERDICT r03
    weak #7)."""
    if skew <= 0:
        return rng.randrange(n)
    return min(n - 1, int(n * (rng.random() ** (1.0 + skew))))


def _member_sample(rng, n: int, k: int, skew: float):
    """The per-gene process memberships: UP TO k distinct indices.
    skew <= 0 is exactly rng.sample (always k, historical draw
    sequence); skew > 0 redraws from the power-law profile, BOUNDED
    (20k tries) so the rng sequence stays deterministic and identical
    between the in-process generator and the canonical writer — at
    extreme skew over a tiny pool a gene can therefore end up with
    fewer than k memberships (both generators shortfall identically, so
    handle parity holds, but workload accounting must not assume
    exactly n_genes*k Member links under skew)."""
    k = min(k, n)
    if skew <= 0:
        return rng.sample(range(n), k)
    out = []
    tries = 0
    while len(out) < k and tries < 20 * k:
        tries += 1
        i = _skew_idx(rng, n, skew)
        if i not in out:
            out.append(i)
    return out


def build_bio_atomspace(
    n_genes: int = 1000,
    n_processes: int = 200,
    members_per_gene: int = 5,
    n_interactions: int = 2000,
    n_evaluations: int = 0,
    seed: int = 42,
    data: Optional[AtomSpaceData] = None,
    skew: float = 0.0,
):
    """Returns (data, genes, processes) with handles for query building.
    `skew` > 0 draws gene/process participation from a power-law profile
    (hub atoms with degrees orders of magnitude above the median) instead
    of uniform — the degree shape of real annotation data."""
    rng = random.Random(seed)
    if data is None:
        data = AtomSpaceData()
    for type_name in ("Gene", "BiologicalProcess", "Member", "Interacts",
                      "Predicate", "Evaluation", "List"):
        _add_type(data, type_name)
    t = data.table
    gene_ct = t.get_named_type_hash("Gene")
    proc_ct = t.get_named_type_hash("BiologicalProcess")

    genes = [_add_node(data, "Gene", f"GENE:{i:07d}") for i in range(n_genes)]
    processes = [
        _add_node(data, "BiologicalProcess", f"GO:{i:07d}")
        for i in range(n_processes)
    ]

    for gi, g in enumerate(genes):
        for p in _member_sample(rng, n_processes, members_per_gene, skew):
            _add_link(data, "Member", [g, processes[p]], [gene_ct, proc_ct])

    for _ in range(n_interactions):
        a = _skew_idx(rng, n_genes, skew)
        b = _skew_idx(rng, n_genes, skew)
        if a == b:
            continue
        # symmetric closure, as the sample KBs store unordered relations
        _add_link(data, "Interacts", [genes[a], genes[b]], [gene_ct, gene_ct])
        _add_link(data, "Interacts", [genes[b], genes[a]], [gene_ct, gene_ct])

    if n_evaluations:
        pred_ct = t.get_named_type_hash("Predicate")
        pred = _add_node(data, "Predicate", "Predicate:has_name")
        for i in range(n_evaluations):
            a = genes[_skew_idx(rng, n_genes, skew)]
            b = processes[_skew_idx(rng, n_processes, skew)]
            inner = _add_link(data, "List", [a, b], [gene_ct, proc_ct])
            _add_link(
                data,
                "Evaluation",
                [pred, inner],
                [pred_ct, [t.get_named_type_hash("List"), gene_ct, proc_ct]],
            )

    return data, genes, processes

