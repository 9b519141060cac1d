"""The port's tree executor (das_tpu_torch/query/plan.py, tree.py,
ops/composite.py, device="cpu") and the store's device probes
(storage/tensor_db.py) against the JAX package's (das_tpu, JAX on the CPU).

On animals, for das_tpu's tree suite (tests/test_differential.py QUERIES,
the benchmark layout-2 shape and the reseed quirk) and for shapes that
reach every (a.kind, b.kind) case of `join_ctables` and every table kind
of `apply_forbidden`: the same answers as sets of assignments, matched and
negation verdicts, the same routes, and every table that `join_ctables`,
`union_ctables`, `difference` and `apply_forbidden` return bit-equal
(kind, columns, count, the valid mask, the values of the valid rows).
`count_matches` equals das_tpu's, None included (an ordered pattern on the
unordered Similarity type).  The store's `probe_*_padded` outputs are
bit-equal before and after an incremental commit, and `get_links`,
`get_matched_type_template` and `get_matched_type` give das_tpu's lists
without the host scans of MemoryDB."""

import numpy as np
import pytest

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.core.hashing import ExpressionHasher as JxHasher
from das_tpu.core.hashing import hex_to_i64 as jx_hex_to_i64
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query import tree as jx_tree
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.query import tree
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.memory_db import MemoryDB
from tests.test_differential import QUERIES, build_query, canon


def N(name):
    return ("node", "Concept", name)


def V(name):
    return ("var", name)


def TV(name):
    return ("tvar", name, "Concept")


def inh(a, b):
    return ("link", "Inheritance", True, [a, b])


def sim(a, b):
    return ("link", "Similarity", False, [a, b])


V1, V2, V3, V4 = V("V1"), V("V2"), V("V3"), V("V4")
M = N("mammal")

#: the benchmark layout-2 shape: And over a term and an Or of a nested And
#: and a term (tests/test_tree.py)
BENCHMARK_Q2 = ("and", [
    inh(N("human"), V1),
    ("or", [("and", [inh(N("monkey"), V2),
                     ("template", "Inheritance", True, [TV("V2"), TV("V3")]),
                     ("template", "Inheritance", True, [TV("V1"), TV("V3")])]),
            inh(N("monkey"), V1)]),
])

#: a disjoint-variable conjunction whose join empties the accumulator: the
#: reference's reseed quirk (tests/test_tree.py)
RESEED = ("and", [inh(N("human"), V1), inh(V1, N("plant")), sim(N("snake"), V2)])

#: shapes that reach every join_ctables kind pair and every table kind of
#: apply_forbidden with answers (an O x U join is viable only when one side's
#: variables hold the other's)
COMPOSITE = [
    ("and", [sim(V1, V2), sim(V2, V3)]),                                    # U x U
    ("and", [sim(V1, V2), inh(V1, M)]),                                     # U x O
    ("and", [inh(V1, V3), inh(V2, V3), sim(V1, V2), inh(V3, V4)]),          # C x O
    ("and", [inh(V1, M), sim(V1, V2), sim(V1, V3)]),                        # C x U
    ("and", [sim(V1, V3), ("and", [inh(V1, M), sim(V1, V2)])]),             # U x C
    ("and", [inh(V1, M), ("and", [inh(V1, M), sim(V1, V2)])]),              # O x C
    ("and", [("and", [inh(V1, M), sim(V1, V2)]),
             ("and", [inh(V1, M), sim(V1, V3)])]),                          # C x C
    ("and", [("and", [inh(V1, M), sim(V1, V2)]),
             ("and", [inh(V1, M), sim(V1, V2)])]),                          # equal blocks
    ("and", [sim(V1, V2), ("not", inh(V1, M))]),                            # U / O
    ("and", [sim(V1, V2), ("not", sim(V1, N("human")))]),                   # U / U
    ("and", [sim(V1, V2), ("not", ("and", [inh(V1, M), sim(V1, V2)]))]),    # U / C
    ("and", [("or", [inh(V1, M), inh(V1, N("plant"))]),
             ("not", inh(N("ent"), V1))]),                                  # O / O
    ("and", [("or", [inh(V1, M), inh(V1, N("plant"))]),
             ("not", sim(V1, V2))]),                                        # O / U
    ("and", [("or", [inh(V1, M), inh(V1, N("plant"))]),
             ("not", ("and", [inh(V1, M), sim(V1, V2)]))]),                 # O / C
    ("and", [inh(V1, M), sim(V1, V2), ("not", inh(V2, M))]),                # C / O
    ("and", [inh(V1, M), sim(V1, V2), ("not", sim(V2, N("chimp")))]),       # C / U
    ("and", [inh(V1, M), sim(V1, V2),
             ("not", ("and", [inh(V1, M), sim(V1, V2)]))]),                 # C / C
    ("or", [("and", [inh(V1, M), sim(V1, V2)]),
            ("and", [inh(V1, N("plant")), sim(V1, V2)])]),                  # union of C
    ("or", [sim(V1, V2), ("not", sim(V1, N("human")))]),                    # difference of U
]

#: outside the tree planner's language: das_tpu's plan.py raises
#: NotCompilable ("ordered pattern on unordered link type")
ORDERED_SIMILARITY = ("or", [inh(V1, V2), ("link", "Similarity", True, [V1, V2])])

SPECS = QUERIES + [BENCHMARK_Q2, RESEED] + COMPOSITE
KIND_PAIRS = {(a, b) for a in "OUC" for b in "OUC"}

#: the commit of the probe tests: new nodes, an ordered and an unordered type
LION_TIGER = '\n'.join(['(: "lion" Concept)', '(: "tiger" Concept)',
                        '(Inheritance "lion" "mammal")', '(Inheritance "tiger" "mammal")',
                        '(Similarity "lion" "tiger")', '(Similarity "tiger" "lion")',
                        '(Similarity "lion" "human")'])


def _pair():
    jx = JxDAS(backend="tensor", data=jx_load(jx_animals()), config=JxConfig())
    pt = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                              device="cpu", config=DasConfig())
    return jx, pt


@pytest.fixture(scope="module")
def animals():
    return _pair()


def _tables(tables):
    """A table list, bit for bit: kind, columns, count, valid, valid rows."""
    out = []
    for t in tables:
        if t is None:
            out.append(None)
            continue
        vals, valid = np.asarray(t.vals), np.asarray(t.valid)
        out.append((t.kind, t.onames, t.ocols, t.ugroups, int(t.count), valid.tolist(),
                    vals[valid].tolist()))
    return out


COMBINATORS = ("join_ctables", "union_ctables", "difference", "apply_forbidden")


def _record(monkeypatch, mod, log):
    """Log every combinator call of a tree module: (name, input kinds,
    output tables)."""
    for name in COMBINATORS:
        orig = getattr(mod, name)

        def wrapped(*args, _orig=orig, _name=name):
            out = _orig(*args)
            kinds = tuple(a.kind for a in args if isinstance(a, mod.CTable))
            log.append((_name, kinds, _tables(out if isinstance(out, list) else [out])))
            return out

        monkeypatch.setattr(mod, name, wrapped)


@pytest.mark.parametrize("spec", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_tree_matches_das_tpu(animals, monkeypatch, spec):
    jx, pt = animals
    jlog, plog = [], []
    _record(monkeypatch, jx_tree, jlog)
    _record(monkeypatch, tree, plog)
    ja, pa = jx_ast.PatternMatchingAnswer(), ast.PatternMatchingAnswer()
    jm = jx_tree.query_tree(jx.db, build_query(jx_ast, spec), ja)
    pm = tree.query_tree(pt.db, build_query(ast, spec), pa)
    assert pm is not None and jm is not None
    assert bool(pm) == bool(jm) and pa.negation == ja.negation
    assert {canon(a) for a in pa.assignments} == {canon(a) for a in ja.assignments}
    assert plog == jlog
    # the facade's route: the tree (a cache hit now), never the host algebra
    j0, p0 = dict(jx_compiler.ROUTE_COUNTS), dict(compiler.ROUTE_COUNTS)
    jm2, ja2 = jx.query_answer(build_query(jx_ast, spec))
    pm2, pa2 = pt.query_answer(build_query(ast, spec))
    jr = {k: jx_compiler.ROUTE_COUNTS[k] - j0[k] for k in ("fused", "staged", "tree", "host")}
    pr = {k: compiler.ROUTE_COUNTS[k] - p0[k] for k in ("fused", "staged", "tree", "host")}
    assert pr == jr and pr["host"] == 0
    assert {canon(a) for a in pa2.assignments} == {canon(a) for a in ja2.assignments}


@pytest.mark.parametrize("spec", SPECS + [ORDERED_SIMILARITY],
                         ids=[str(i) for i in range(len(SPECS) + 1)])
def test_count_matches_matches_das_tpu(animals, spec):
    jx, pt = animals
    want = jx_compiler.count_matches(jx.db, build_query(jx_ast, spec))
    assert compiler.count_matches(pt.db, build_query(ast, spec)) == want
    if spec is ORDERED_SIMILARITY:
        assert want is None


def test_every_join_kind_pair_reached(monkeypatch):
    """The suite above reaches all nine (a.kind, b.kind) cases of
    join_ctables and every answer kind of apply_forbidden (on a fresh
    store: no cached tree answers)."""
    _jx, pt = _pair()
    log = []
    _record(monkeypatch, tree, log)
    for spec in SPECS:
        tree.query_tree(pt.db, build_query(ast, spec), ast.PatternMatchingAnswer())
    joins = {k for name, k, out in log if name == "join_ctables"}
    joined = {k for name, k, out in log if name == "join_ctables" and out != [None]}
    assert joins == joined == KIND_PAIRS
    forbidden = {k[0] for name, k, _ in log if name == "apply_forbidden"}
    assert forbidden == set("OUC")
    assert any(name == "difference" for name, _, _ in log)


# -- the store's device probes ------------------------------------------------


def _row(das, name):
    return das.db.fin.row_of_hex[das.db.get_node_handle("Concept", name)]


def _ctype(hasher, to_i64, das, names):
    table = das.db.data.table
    return int(to_i64(hasher.composite_hash([table.get_named_type_hash(n) for n in names])))


def _probes(das, kind, hasher, to_i64, extra=()):
    """Every probe of one kind over animals: (label, (local, mask) as lists)."""
    db = das.db
    inh_t, sim_t = db._type_id("Inheritance"), db._type_id("Similarity")
    names = ["human", "mammal", "snake", *extra]
    rows = {n: _row(das, n) for n in names}
    if kind == "ordered":
        calls = [(inh_t, ((0, rows["human"]),)), (inh_t, ((1, rows["mammal"]),)),
                 (inh_t, ((0, rows["human"]), (1, rows["mammal"]))), (inh_t, ()),
                 (None, ((1, rows["mammal"]),)), (None, ()), (sim_t, ((0, rows["snake"]),))]
        calls += [(inh_t, ((0, rows[n]),)) for n in extra]
        out = [db.probe_ordered_padded(2, t, f) for t, f in calls]
    elif kind == "unordered":
        calls = [(sim_t, ((rows["human"], 1),)), (sim_t, ((rows["human"], 2),)),
                 (None, ((rows["snake"], 1),)), (sim_t, ()),
                 (sim_t, tuple(sorted(((rows["human"], 1), (rows["snake"], 1)))))]
        calls += [(sim_t, ((rows[n], 1),)) for n in extra]
        out = [db.probe_unordered_padded(2, t, r) for t, r in calls]
    else:
        out = [db.probe_ctype_padded(2, _ctype(hasher, to_i64, das, [t, "Concept", "Concept"]))
               for t in ("Inheritance", "Similarity", "List")]
        out.append(db.probe_ctype_padded(3, 0))
    return [None if o is None else (np.asarray(o[0]).tolist(), np.asarray(o[1]).tolist())
            for o in out]


@pytest.mark.parametrize("kind", ["ordered", "unordered", "ctype"])
def test_probe_padded_matches_das_tpu(kind):
    from das_tpu_torch.core.hashing import ExpressionHasher, hex_to_i64

    jx, pt = _pair()
    want = _probes(jx, kind, JxHasher, jx_hex_to_i64)
    assert _probes(pt, kind, ExpressionHasher, hex_to_i64) == want
    assert any(o is not None and any(o[1]) for o in want)
    jx.load_metta_text(LION_TIGER)
    pt.load_metta_text(LION_TIGER)
    assert pt.db._delta_total == jx.db._delta_total > 0   # incremental, both
    extra = ("lion", "tiger")
    want = _probes(jx, kind, JxHasher, jx_hex_to_i64, extra)
    assert _probes(pt, kind, ExpressionHasher, hex_to_i64, extra) == want


def _read_calls(das, names):
    h = {n: das.db.get_node_handle("Concept", n) for n in names}
    return [
        das.get_links("Inheritance", targets=[h["human"], "*"]),
        das.get_links("Inheritance", targets=["*", h["mammal"]]),
        das.get_links("Similarity", targets=[h["human"], "*"]),
        das.get_links("Similarity", targets=["*", h["human"]]),
        das.get_links("*", targets=[h["snake"], "*"]),
        das.get_links("Inheritance", target_types=["Concept", "Concept"]),
        das.get_links("Similarity"),
        das.db.get_matched_links("Similarity", [h["human"], "*"]),
        das.db.get_matched_links("*", ["*", h["mammal"]]),
        das.db.get_matched_type_template(["Similarity", "Concept", "Concept"]),
        das.db.get_matched_type("Inheritance"),
    ] + [das.get_links("Similarity", targets=[h[n], "*"]) for n in names[3:]]


def test_get_links_on_device_probes(monkeypatch):
    """The read surface gives das_tpu's lists (same order) through the
    device probes, before and after a commit; MemoryDB's host scans are
    not called, and the answers equal theirs as sets."""
    jx, pt = _pair()
    host = MemoryDB(load_metta_text(animals_metta()))
    names = ["human", "mammal", "snake"]
    want_host = [sorted(host.get_matched_links("Similarity",
                                               [host.get_node_handle("Concept", "human"),
                                                "*"]))]

    def no_scan(*a, **k):
        raise AssertionError("MemoryDB host scan on a TensorDB")

    for fn in ("get_matched_links", "get_matched_type_template", "get_matched_type"):
        monkeypatch.setattr(MemoryDB, fn, no_scan)
    got = _read_calls(pt, names)
    assert got == _read_calls(jx, names)
    assert [sorted(got[7])] == want_host
    jx.load_metta_text(LION_TIGER)
    pt.load_metta_text(LION_TIGER)
    names += ["lion", "tiger"]
    got = _read_calls(pt, names)
    assert got == _read_calls(jx, names)
    assert got[-2] and got[-1]   # the committed Similarity links
