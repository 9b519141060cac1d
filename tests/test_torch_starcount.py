"""Star counting (`das_tpu_torch/query/starcount.py`) against the JAX
package's: every star conjunction of `tests/test_starcount.py` counted by
the port under both fold editions (the host edition of the entry points
and the device edition `_device_count_group`), held exactly against
`das_tpu`'s host fold and against the port's own general path (the fused
count, else the staged pipeline), before and after incremental commits;
the shapes `plan_star` declines; the `star` route counter; and the
planner's degree-product estimates, whose supports now come from the
star module."""

import numpy as np
import pytest

from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.planner.stats import CardinalityEstimator as JxEstimator
from das_tpu.query import ast as jx_ast
from das_tpu.query import compiler as jx_compiler
from das_tpu.query import starcount as jx_starcount
from das_tpu.storage import atom_table as jx_atom_table
from das_tpu.storage.tensor_db import TensorDB as JxTensorDB
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.planner.stats import CardinalityEstimator
from das_tpu_torch.query import ast, compiler, starcount
from das_tpu_torch.storage import atom_table
from das_tpu_torch.storage.atom_table import host_segments
from das_tpu_torch.storage.tensor_db import TensorDB

#: the bio KB of tests/test_starcount.py
CFG = dict(n_genes=120, n_processes=10, members_per_gene=4, n_interactions=150,
           n_evaluations=30)
FOLDS = ("host", "device")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """das_tpu's side runs its host fold (no JAX compile), with its star
    route on; the port reads only its DasConfig."""
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    monkeypatch.setenv("DAS_TPU_STAR_FOLD", "host")
    for var in ("DAS_TPU_STAR", "DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER",
                "DAS_TPU_VMEM_BUDGET"):
        monkeypatch.delenv(var, raising=False)


def _fold(db, lanes, fold):
    """The lanes' counts by one edition of the fold."""
    if fold == "device":
        return starcount._device_count_group(db, lanes)
    return starcount.star_count_many(db, lanes)


def _names(pdb):
    genes = pdb.get_all_nodes("Gene", names=True)
    # a gene with no outgoing Interacts: its grounded term is empty
    empty = next(g for g in genes if compiler.count_matches(pdb, ast.Link(
        "Interacts", [ast.Node("Gene", g), ast.Variable("V0")], True)) == 0)
    return {"genes": genes, "procs": pdb.get_all_nodes("BiologicalProcess", names=True),
            "empty_gene": empty}


def _pair(cfg=CFG):
    jdata, _, _ = jx_bio(**cfg)
    pdata, _, _ = build_bio_atomspace(**cfg)
    return JxTensorDB(jdata, JxConfig()), TensorDB(pdata, DasConfig(), device="cpu")


@pytest.fixture(scope="module")
def bio():
    jdb, pdb = _pair()
    return jdb, pdb, _names(pdb)


# -- the cases: (mod, names) -> (query, what the count must show) ----------------


def _whole_table(m, n):
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("V0"), V("T0_V1")], True),
                  L("Interacts", [V("V0"), V("T1_V1")], True)]), "positive"


def _three_way(m, n):
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("V0"), V("T0_V1")], True),
                  L("Member", [V("V0"), V("T1_V1")], True),
                  L("Interacts", [V("V0"), V("T2_V1")], True)]), "positive"


def _identical_terms(m, n):
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("V0"), V("A")], True),
                  L("Member", [V("V0"), V("B")], True)]), "positive"


def _sparse_table(m, n):
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Member", [V("V0"), N("BiologicalProcess", n["procs"][0])], True),
                  L("Interacts", [V("V0"), V("T1_V1")], True)]), "positive"


def _sparse_sparse(m, n):
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Member", [V("V0"), N("BiologicalProcess", n["procs"][0])], True),
                  L("Member", [V("V0"), N("BiologicalProcess", n["procs"][1])], True),
                  L("Member", [V("V0"), V("T2_V1")], True)]), "positive"


def _second_position(m, n):
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("T0_V1"), V("V0")], True),
                  L("Member", [V("T1_V1"), V("V0")], True)]), "positive"


def _midfold_reseed(m, n):
    """The second join is disjoint: the reference re-seeds from term 3."""
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Member", [V("V0"), N("BiologicalProcess", n["procs"][0])], True),
                  L("Member", [N("Gene", n["genes"][0]), V("V0")], True),
                  L("Member", [V("T2_V1"), V("V0")], True)]), "positive"


def _final_join_zero(m, n):
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Member", [V("V0"), N("BiologicalProcess", n["procs"][0])], True),
                  L("Member", [V("V0"), V("T1_V1")], True),
                  L("Member", [N("Gene", n["genes"][0]), V("V0")], True)]), "zero"


def _two_term_disjoint(m, n):
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Member", [V("V0"), N("BiologicalProcess", n["procs"][0])], True),
                  L("Member", [N("Gene", n["genes"][0]), V("V0")], True)]), "zero"


def _empty_term(m, n):
    """An empty positive term answers 0, though the fold would reseed."""
    L, V, N = m.Link, m.Variable, m.Node
    return m.And([L("Interacts", [N("Gene", n["empty_gene"]), V("V0")], True),
                  L("Member", [V("V0"), V("T1_V1")], True)]), "zero"


def _missing_bucket(m, n):
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("V0")] + [V(c) for c in "ABCDE"], True),
                  L("Member", [V("V0"), V("F")], True)]), "zero"


def _int64_products(m, n):
    """16 whole-table terms: 4^16 per gene, past int32 (no general path)."""
    L, V = m.Link, m.Variable
    return m.And([L("Member", [V("V0"), V(f"T{i}_V1")], True) for i in range(16)]), "int64"


CASES = [_whole_table, _three_way, _identical_terms, _sparse_table, _sparse_sparse,
         _second_position, _midfold_reseed, _final_join_zero, _two_term_disjoint,
         _empty_term, _missing_bucket, _int64_products]


def _port_counts(pdb, pq):
    """{fold: the port's star count} and the plans."""
    plans = compiler.plan_query(pdb, pq)
    got = {"host": starcount.try_star_count(pdb, plans),
           "device": _fold(pdb, [starcount.plan_star(pdb, plans)], "device")[0]}
    return got, plans


def _general(pdb, pq):
    """The general executors' count, what count_matches runs for a shape
    that is not a star: the fused count, else the staged pipeline."""
    plans = compiler.plan_query(pdb, pq)
    table = compiler._execute_fused(pdb, plans, count_only=True)
    return compiler.count_matches_staged(pdb, plans) if table is None else table.count


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__.strip("_"))
def test_star_count_matches_das_tpu_and_general_path(bio, case):
    jdb, pdb, names = bio
    jq, expect = case(jx_ast, names)
    pq, _ = case(ast, names)
    jplans = jx_compiler.plan_query(jdb, jq)
    want = jx_starcount.try_star_count(jdb, jplans)
    got, plans = _port_counts(pdb, pq)
    assert starcount.plan_star(pdb, plans).specs == jx_starcount.plan_star(jdb, jplans).specs
    assert got == {fold: want for fold in FOLDS}
    if expect == "int64":
        b = pdb.fin.buckets[2]
        member = pdb._type_id("Member")
        deg = np.bincount(b.targets[b.type_id == member, 0]).astype(np.int64)
        assert want == int((deg ** 16).sum()) > 2 ** 31
    else:
        assert want == _general(pdb, pq)
        assert (want > 0) if expect == "positive" else (want == 0)


def test_star_count_many_mixed_lanes_in_one_call(bio):
    """Every case as one lane list: the device edition fetches once per
    GROUP of 12 lanes, and each lane keeps its own answer."""
    jdb, pdb, names = bio
    jlanes = [jx_starcount.plan_star(jdb, jx_compiler.plan_query(jdb, c(jx_ast, names)[0]))
              for c in CASES]
    lanes = [starcount.plan_star(pdb, compiler.plan_query(pdb, c(ast, names)[0]))
             for c in CASES]
    want = jx_starcount.star_count_many(jdb, jlanes)
    assert starcount.star_count_many(pdb, lanes) == want
    f0 = starcount.FETCHES["n"]
    assert _fold(pdb, lanes + lanes, "device") == want + want
    assert starcount.FETCHES["n"] - f0 == -(-2 * len(lanes) // starcount.GROUP)


def _declined(m, n):
    L, V, N, T = m.Link, m.Variable, m.Node, m.LinkTemplate
    g = N("Gene", n["genes"][0])
    return {
        "negated": m.And([L("Member", [V("V0"), V("A")], True),
                          m.Not(L("Interacts", [V("V0"), g], True))]),
        "template": m.And([L("Member", [V("V0"), V("A")], True),
                           T("Interacts", [m.TypedVariable("V0", "Gene"),
                                           m.TypedVariable("B", "Gene")], True)]),
        "eq_pairs": m.And([L("Interacts", [V("V0"), V("V0")], True),
                           L("Member", [V("V0"), V("A")], True)]),
        "two_shared": m.And([L("Member", [V("V1"), V("V3")], True),
                             L("Member", [V("V2"), V("V3")], True),
                             L("Interacts", [V("V1"), V("V2")], True)]),
        "two_shared_pair": m.And([L("Interacts", [V("A"), V("B")], True),
                                  L("Interacts", [V("B"), V("A")], True)]),
        "one_term": L("Member", [V("V0"), V("V1")], True),
    }


@pytest.mark.parametrize("shape", ["negated", "template", "eq_pairs", "two_shared",
                                   "two_shared_pair", "one_term"])
def test_plan_star_declines_like_das_tpu(bio, shape):
    jdb, pdb, names = bio
    jplans = jx_compiler.plan_query(jdb, _declined(jx_ast, names)[shape])
    plans = compiler.plan_query(pdb, _declined(ast, names)[shape])
    assert (plans is None) == (jplans is None)
    assert jx_starcount.plan_star(jdb, jplans) is None
    assert starcount.plan_star(pdb, plans) is None


def test_route_counts_star_equal_das_tpu(bio):
    """count_matches over a fixed list (the star cases and two single
    terms, which the host answers) counts the same star routes."""
    jdb, pdb, names = bio
    singles = [lambda m, n: (m.Link("Member", [m.Variable("A"), m.Variable("B")], True), 0),
               lambda m, n: (m.Link("Member", [m.Node("Gene", n["genes"][1]),
                                               m.Variable("B")], True), 0)]
    jx_compiler.reset_route_counts()
    compiler.reset_route_counts()
    for case in CASES + singles:
        assert (compiler.count_matches(pdb, case(ast, names)[0])
                == jx_compiler.count_matches(jdb, case(jx_ast, names)[0]))
    assert compiler.ROUTE_COUNTS["star"] == jx_compiler.ROUTE_COUNTS["star"] == len(CASES)
    assert sum(compiler.ROUTE_COUNTS.values()) == len(CASES)


def test_planner_estimates_equal_das_tpu(bio):
    """exact_join_rows and multiway_rows read their supports from the star
    module now: equal to das_tpu's estimator on the same plans."""
    jdb, pdb, names = bio

    def terms(m):
        L, V, N = m.Link, m.Variable, m.Node
        return [L("Member", [V("V0"), V("A")], True),
                L("Member", [V("B"), V("V0")], True),
                L("Interacts", [V("V0"), V("C")], True),
                L("Member", [V("V0"), N("BiologicalProcess", names["procs"][2])], True),
                L("Member", [N("Gene", names["genes"][3]), V("V0")], True),
                L("Interacts", [N("Gene", names["genes"][4]), V("V0")], True)]

    jplans = [jx_compiler.plan_query(jdb, t)[0] for t in terms(jx_ast)]
    plans = [compiler.plan_query(pdb, t)[0] for t in terms(ast)]
    jest, est = JxEstimator(jdb), CardinalityEstimator(pdb)
    for i in range(len(plans)):
        for j in range(len(plans)):
            assert (est.exact_join_rows(plans[i], plans[j], "V0")
                    == jest.exact_join_rows(jplans[i], jplans[j], "V0"))
    for idx in ((0, 2, 3), (0, 1, 2), (3, 5), (2, 4, 5), (0, 1, 2, 3, 4, 5)):
        want = jest.multiway_rows([jplans[i] for i in idx], "V0")
        assert est.multiway_rows([plans[i] for i in idx], "V0") == want
        assert want[1] is True


# -- after incremental commits ---------------------------------------------------


def _commit_text(tag, names, k):
    """New genes with Member and Interacts links, and links from existing
    genes: the same values land in base and overlay segments."""
    g, p = names["genes"], names["procs"]
    lines = [f'(: "{x}" Gene)' for x in g[:6]] + [f'(: "{x}" BiologicalProcess)' for x in p[:4]]
    for i in range(k):
        new = f"SGX_{tag}_{i}"
        lines += [f'(: "{new}" Gene)', f'(Member "{new}" "{p[i % 4]}")',
                  f'(Interacts "{new}" "{g[i % 6]}")', f'(Interacts "{g[i % 6]}" "{new}")']
    lines += [f'(Member "{g[i]}" "{p[(i + 2) % 4]}")' for i in range(6)]
    return "\n".join(lines)


@pytest.mark.parametrize("fold", FOLDS)
def test_star_counts_after_commits(fold):
    """Two incremental commits after one edition's caches were warmed:
    overlay segments (the multi-segment merge of `_table_sparse`), caches
    invalidated by segment identity (host) and by (bucket, atom_count)
    (device).  das_tpu's reference is its host fold on a store built fresh
    from the committed data (counts do not depend on row order)."""
    jdb, pdb = _pair()
    names = _names(pdb)
    for case in CASES:   # warm every cache of this edition
        _fold(pdb, [starcount.plan_star(pdb, compiler.plan_query(pdb, case(ast, names)[0]))],
              fold)
    seg0 = len(host_segments(pdb, 2))
    for tag in ("a", "b"):
        text = _commit_text(f"{fold}{tag}", names, 8)
        atom_table.load_metta_text(text, pdb.data)
        jx_atom_table.load_metta_text(text, jdb.data)
        v0 = pdb.delta_version
        pdb.refresh()
        assert pdb.delta_version == v0 + 1 and pdb._delta_total > 0
    assert len(host_segments(pdb, 2)) == seg0 + 2
    fresh = JxTensorDB(jdb.data, JxConfig())
    for case in CASES:
        jq, expect = case(jx_ast, names)
        pq = case(ast, names)[0]
        want = jx_starcount.try_star_count(fresh, jx_compiler.plan_query(fresh, jq))
        got, _ = _port_counts(pdb, pq)
        assert got == {f: want for f in FOLDS}, case.__name__
        if expect != "int64":
            assert want == _general(pdb, pq), case.__name__


def test_device_cache_stale_length_after_mixed_arity_commit():
    """A commit that grows the atom count while the arity-1 bucket stays
    the same object must not serve that arity's cached degree vector at
    the old length."""
    text = "\n".join(["(: Concept Type)", "(: List Type)", "(: Pair Type)"]
                     + [f'(: "c{i}" Concept)' for i in range(6)]
                     + [f'(List "c{i}")' for i in range(6)]
                     + [f'(Pair "c{i}" "c{(i + 1) % 6}")' for i in range(6)])
    jdata = jx_atom_table.load_metta_text(text)
    db = TensorDB(atom_table.load_metta_text(text), DasConfig(), device="cpu")

    def q(m):
        return m.And([m.Link("List", [m.Variable("V0")], True),
                      m.Link("Pair", [m.Variable("V0"), m.Variable("A")], True)])

    lane = starcount.plan_star(db, compiler.plan_query(db, q(ast)))
    assert _fold(db, [lane], "device") == [6]
    bucket1, atoms = db.dev.buckets[1], db.fin.atom_count
    extra = '(: "c_new" Concept)\n(Pair "c_new" "c0")'
    atom_table.load_metta_text(extra, db.data)
    jx_atom_table.load_metta_text(extra, jdata)
    db.refresh()
    assert db.dev.buckets[1] is bucket1 and db.fin.atom_count > atoms
    fresh = JxTensorDB(jdata, JxConfig())
    want = jx_starcount.try_star_count(fresh, jx_compiler.plan_query(fresh, q(jx_ast)))
    lane = starcount.plan_star(db, compiler.plan_query(db, q(ast)))
    for fold in FOLDS:
        assert _fold(db, [lane], fold) == [want] == [6]


def test_same_probe_shared_at_two_positions():
    """One probe (arity, type, fixed) with the shared variable at two
    positions: the device edition caches the probe without the position
    and gathers per position."""
    text = "\n".join(["(: Concept Type)", "(: Triple Type)", "(: Rel Type)"]
                     + [f'(: "c{i}" Concept)' for i in range(6)]
                     + [f'(Triple "c0" "c{i}" "c{(i * 2) % 6}")' for i in range(1, 6)]
                     + [f'(Rel "c{i}" "c{(i + 3) % 6}")' for i in range(6)]
                     + ['(Rel "c2" "c0")', '(Rel "c4" "c0")', '(Rel "c4" "c2")'])
    jdb = JxTensorDB(jx_atom_table.load_metta_text(text), JxConfig())
    db = TensorDB(atom_table.load_metta_text(text), DasConfig(), device="cpu")

    def qs(m):
        L, V, N = m.Link, m.Variable, m.Node
        c0 = N("Concept", "c0")
        return [m.And([L("Triple", [c0, V("V0"), V("A")], True),
                       L("Rel", [V("V0"), V("B")], True)]),
                m.And([L("Triple", [c0, V("A"), V("V0")], True),
                       L("Rel", [V("V0"), V("B")], True)])]

    jlanes = [jx_starcount.plan_star(jdb, jx_compiler.plan_query(jdb, q)) for q in qs(jx_ast)]
    lanes = [starcount.plan_star(db, compiler.plan_query(db, q)) for q in qs(ast)]
    want = jx_starcount.star_count_many(jdb, jlanes)
    assert want[0] != want[1] and min(want) > 0
    for fold in FOLDS:
        assert _fold(db, lanes, fold) == want
    assert [_general(db, q) for q in qs(ast)] == want


def test_dangling_rows_never_join():
    """A whole-table term whose rows dangle at the shared position counts
    the real rows only (the symbolic total feeds the empty-term guard and a
    reseed that lands on it): both editions answer 1, as das_tpu does."""
    text = "\n".join(["(: Rel Type)", "(: Tab Type)", "(: Concept Type)"]
                     + [f'(: "c{i}" Concept)' for i in range(4)]
                     + ['(Rel "c0" "c1")', '(Rel "c0" "c2")', '(Tab "c3" "c0")'])
    pair = []
    for mod in (jx_atom_table, atom_table):
        data = mod.load_metta_text(text)
        tab = next(rec for rec in data.links.values() if rec.named_type == "Tab")
        for i in range(2):
            data.links[f"{i:x}" * 32] = mod.LinkRec(
                named_type=tab.named_type, named_type_hash=tab.named_type_hash,
                composite_type=tab.composite_type,
                composite_type_hash=tab.composite_type_hash,
                elements=("e" * 31 + str(i), tab.elements[1]), is_toplevel=True)
        pair.append(data)
    jdb = JxTensorDB(pair[0], JxConfig())
    db = TensorDB(pair[1], DasConfig(), device="cpu")
    assert db.fin.dangling_hexes

    def q(m):
        L, V, N = m.Link, m.Variable, m.Node
        return m.And([L("Rel", [N("Concept", "c0"), V("V0")], True),
                      L("Rel", [V("V0"), N("Concept", "c1")], True),
                      L("Tab", [V("V0"), V("T2_V1")], True)])

    def probed(m):
        # the probed Tab term binds V0 at the dangling position
        L, V, N = m.Link, m.Variable, m.Node
        return m.And([L("Tab", [V("V0"), N("Concept", "c0")], True)] * 2)

    for build in (q, probed):
        want = jx_starcount.try_star_count(jdb, jx_compiler.plan_query(jdb, build(jx_ast)))
        got, _ = _port_counts(db, build(ast))
        assert got == {f: want for f in FOLDS} and want == 1


def test_skewed_kb_star_counts():
    """A power-law degree profile (hub processes and genes) keeps the
    counts exact in both editions."""
    cfg = dict(n_genes=400, n_processes=60, members_per_gene=4, n_interactions=500,
               n_evaluations=0, seed=5, skew=1.5)
    jdb, pdb = _pair(cfg)

    def q(m):
        L, V, N = m.Link, m.Variable, m.Node
        return m.And([L("Member", [V("V0"), N("BiologicalProcess", "GO:0000000")], True),
                      L("Member", [V("V0"), V("T1_V1")], True),
                      L("Interacts", [V("V0"), V("T2_V1")], True)])

    want = jx_starcount.try_star_count(jdb, jx_compiler.plan_query(jdb, q(jx_ast)))
    got, _ = _port_counts(pdb, q(ast))
    assert got == {f: want for f in FOLDS} and want > 0
    assert want == _general(pdb, q(ast))


def test_evict_oldest_is_fifo_and_partial():
    cache = {("sparse", i): i for i in range(300)}
    cache[("dense", 0)] = "keep"
    starcount._evict_oldest(cache, lambda k: k[0] == "sparse", 192)
    assert [k for k in cache if k[0] == "sparse"] == [("sparse", i) for i in range(108, 300)]
    assert cache[("dense", 0)] == "keep"


def test_host_cache_is_bounded_fifo(bio):
    """The host supports are bounded as in das_tpu: past 256 entries the
    oldest are evicted down to 192, and the survivors are the newest."""
    _jdb, pdb, names = bio
    pdb._star_host_cache = {}
    member, inter = pdb._type_id("Member"), pdb._type_id("Interacts")

    def row(t, name):
        return pdb._row_of(pdb.get_node_handle(t, name))

    specs = [(2, tid, 1, ((0, row("Gene", g)),)) for tid in (member, inter)
             for g in names["genes"]]
    specs += [(2, member, 0, ((1, row("BiologicalProcess", p)),)) for p in names["procs"]]
    specs += [(2, inter, 0, ((1, row("Gene", g)),)) for g in names["genes"][:20]]
    for s in specs:
        starcount._host_sparse_deg(pdb, s)
    keys = list(pdb._star_host_cache)
    # one eviction, at the 258th insert: 192 kept, then 12 more
    assert len(specs) == 270 and len(keys) == 192 + (270 - 257)
    assert keys == [("sparse",) + s for s in specs[-len(keys):]]
