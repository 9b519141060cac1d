"""The port's `explain` and the facade's read surface against the JAX
package's (das_tpu, JAX on the CPU).

`explain` on the SMALL bio configuration with the planner on: the same
dict for the grounded query, its Not variant, the triangle, a grounded
star and a fan-out star, with execute false and true and with
compile=True, and the same `PLANNER_COUNTS["explain"]` and host-fetch
deltas.  The one field that differs is `compile.digest`: both are the md5
of the executed plan signature's repr, folded to 16 hex chars, but the
JAX signature carries fields the port's has not (the Pallas route, tiling,
VMEM budget, planner flag), so the reprs and the digests differ.  A query
outside the compiled conjunctive subset (an `Or`, or a conjunction
grounded on an atom the store lacks) reports the tree executor: the same
dict as das_tpu's.

The read surface on animals: every getter gives das_tpu's answer in all
three output formats."""

import json

import pytest

from das_tpu import planner as jx_planner
from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu.api.atomspace import QueryOutputFormat as JxFormat
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.models.bio import build_bio_atomspace as jx_bio
from das_tpu.query import ast as jx_ast
from das_tpu.query import fused as jx_fused
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch import planner
from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.models.bio import build_bio_atomspace
from das_tpu_torch.query import ast
from das_tpu_torch.query import fused
from das_tpu_torch.storage.atom_table import load_metta_text
from tests.test_torch_planner import _family, _partner_procs

#: bench.py SMALL
SMALL = dict(n_genes=300, n_processes=30, members_per_gene=5, n_interactions=300,
             n_evaluations=0, seed=11)

EXPLAINED = ["grounded", "grounded_not", "triangle", "grounded_star", "fanout_star"]


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.setenv("DAS_TPU_XLA_CACHE", "0")
    for var in ("DAS_TPU_MULTIWAY", "DAS_TPU_PLANNER", "DAS_TPU_PLANNER_DP_MAX",
                "DAS_TPU_PALLAS", "DAS_TPU_VMEM_BUDGET", "DAS_TPU_STAR", "DAS_TPU_PROFLOG"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bio():
    jdata, genes, procs = jx_bio(**SMALL)
    pdata, _, _ = build_bio_atomspace(**SMALL)
    genes = [jdata.nodes[h].name for h in genes]
    procs = [jdata.nodes[h].name for h in procs]
    jx = JxDAS(backend="tensor", data=jdata, config=JxConfig())
    pt = DistributedAtomSpace(backend="tensor", data=pdata, device="cpu", config=DasConfig())
    return jx, pt, genes, procs, _partner_procs(pdata, genes)


def _explain_both(bio, name, **kw):
    """(das_tpu's dict, the port's dict, explain-counter deltas, fetch deltas)."""
    jx, pt, genes, procs, partner = bio
    out, counts, fetches = [], [], []
    for das, m, pl, fz in ((jx, jx_ast, jx_planner, jx_fused), (pt, ast, planner, fused)):
        q = _family(m, genes, procs, partner)[name]
        e0, f0 = pl.PLANNER_COUNTS["explain"], fz.FETCH_COUNTS["n"]
        out.append(das.explain(q, **kw))
        counts.append(pl.PLANNER_COUNTS["explain"] - e0)
        fetches.append(fz.FETCH_COUNTS["n"] - f0)
    return out[0], out[1], counts, fetches


@pytest.mark.parametrize("name", EXPLAINED)
def test_explain_plan_matches_das_tpu(bio, name):
    want, got, counts, fetches = _explain_both(bio, name)
    assert got == want
    assert got["planned"] and got["planner_enabled"]
    assert counts == [1, 1] and fetches == [0, 0]
    if name.endswith("star"):
        assert got["multiway"] > 0


@pytest.mark.parametrize("name", EXPLAINED)
def test_explain_execute_matches_das_tpu(bio, name):
    want, got, counts, fetches = _explain_both(bio, name, execute=True)
    assert got == want
    assert counts == [1, 1] and fetches[0] == fetches[1] >= 1
    assert got["actual"]["count"] > 0 and got["actual"]["retry_rounds"] == fetches[1] - 1
    # warm: the learned capacities answer in round 0, one fetch
    want, got, counts, fetches = _explain_both(bio, name, compile=True)
    jc, pc = want.pop("compile"), got.pop("compile")
    assert got == want and fetches == [1, 1]
    assert got["actual"]["retry_rounds"] == 0
    assert pc["enabled"] is jc["enabled"] is False and pc["rows"] == jc["rows"] == []
    assert len(pc["digest"]) == len(jc["digest"]) == 16
    int(pc["digest"], 16)


def test_explain_outside_the_conjunctive_subset(bio):
    """The tree executor's explain: an Or of grounded Member / Interacts
    terms is one fused tree job ("fused_tree"), a conjunction on an unknown
    atom is a tree with no conjunctive site; the dicts equal das_tpu's,
    planned, executed and with the compile block (but its digest)."""
    jx, pt, genes, procs, partner = bio

    def queries(m):
        L, V, N = m.Link, m.Variable, m.Node
        return [m.Or([L("Member", [N("Gene", genes[0]), V("V3")], True),
                      L("Interacts", [N("Gene", genes[0]), V("V3")], True)]),
                m.And([L("Member", [N("Gene", "no such gene"), V("V3")], True),
                       L("Member", [V("V2"), V("V3")], True)])]

    # das_tpu's single-device explain never asks plan_query for the
    # EMPTY_PLAN sentinel, so the unknown atom plans as a tree
    routes = ["fused_tree", "tree"]
    for jq, pq, route in zip(queries(jx_ast), queries(ast), routes):
        for kw in ({}, {"execute": True}, {"compile": True}):
            e0, je0 = planner.PLANNER_COUNTS["explain"], jx_planner.PLANNER_COUNTS["explain"]
            want, got = jx.explain(jq, **kw), pt.explain(pq, **kw)
            assert (planner.PLANNER_COUNTS["explain"] - e0
                    == jx_planner.PLANNER_COUNTS["explain"] - je0)
            jc, pc = want.pop("compile", None), got.pop("compile", None)
            assert (jc is None) == (pc is None) == (route == "tree" or "compile" not in kw)
            if pc is not None:
                assert pc["enabled"] is jc["enabled"] is False and pc["rows"] == jc["rows"] == []
                assert len(pc["digest"]) == len(jc["digest"]) == 16
            assert got == want
            assert got["route"] == route
    assert pt.explain(queries(ast)[1]) == {"route": "tree", "planned": False, "sites": []}
    executed = pt.explain(queries(ast)[0], execute=True)
    assert executed["tree_fused"] and executed["actual"]["count"] > 0


# -- the read surface ---------------------------------------------------------


@pytest.fixture(scope="module")
def animals():
    jx = JxDAS(backend="tensor", data=jx_load(jx_animals()), config=JxConfig())
    pt = DistributedAtomSpace(backend="tensor", data=load_metta_text(animals_metta()),
                              device="cpu")
    return jx, pt


FORMATS = [(JxFormat.HANDLE, QueryOutputFormat.HANDLE),
           (JxFormat.ATOM_INFO, QueryOutputFormat.ATOM_INFO),
           (JxFormat.JSON, QueryOutputFormat.JSON)]


def _same(pair, fmt, fn, sort=False):
    """fn(das, output format) in both packages gives the same answer; lists
    compare as multisets when `sort` (the JAX store probes on the device,
    the port's on the host, and their matches come in different orders)."""
    want, got = (fn(das, f) for das, f in zip(pair, fmt))
    if sort:
        if isinstance(want, str):
            want, got = json.loads(want), json.loads(got)
        want = sorted(json.dumps(x, sort_keys=True) for x in want)
        got = sorted(json.dumps(x, sort_keys=True) for x in got)
    assert got == want
    return got


@pytest.mark.parametrize("fmt", FORMATS, ids=["handle", "atom_info", "json"])
def test_read_surface_matches_das_tpu(animals, fmt):
    h = animals[1].get_node("Concept", "human")
    m = animals[1].get_node("Concept", "mammal")
    assert _same(animals, fmt, lambda d, f: d.get_node("Concept", "human", output_format=f))
    assert _same(animals, fmt,
                 lambda d, f: d.get_node("Concept", "nobody", output_format=f)) is None
    assert _same(animals, fmt, lambda d, f: d.get_nodes("Concept", output_format=f), sort=True)
    assert _same(animals, fmt, lambda d, f: d.get_nodes("Concept", "human", output_format=f))
    assert _same(animals, fmt,
                 lambda d, f: d.get_nodes("Concept", "nobody", output_format=f)) == []
    assert _same(animals, fmt, lambda d, f: d.get_link("Inheritance", [h, m], output_format=f))
    assert _same(animals, fmt,
                 lambda d, f: d.get_link("Inheritance", [m, h], output_format=f)) is None
    links = [
        lambda d, f: d.get_links("Inheritance", output_format=f),
        lambda d, f: d.get_links("Inheritance", target_types=["Concept", "Concept"],
                                 output_format=f),
        lambda d, f: d.get_links("Inheritance", targets=["*", m], output_format=f),
        lambda d, f: d.get_links("Inheritance", targets=[h, "*"], output_format=f),
        # unordered wildcard probes: the reference's sorted-probe filter
        lambda d, f: d.get_links("Similarity", targets=[h, "*"], output_format=f),
        lambda d, f: d.get_links("Similarity", targets=["*", h], output_format=f),
        lambda d, f: d.get_links(None, targets=[h, "*"], output_format=f),
        lambda d, f: d.get_links("Similarity", targets=[h, h], output_format=f),
    ]
    for fn in links:
        _same(animals, fmt, fn, sort=True)
    for bad in (lambda d, f: d.get_links(None, output_format=f),
                lambda d, f: d.get_links("*", output_format=f),
                lambda d, f: d.get_node("Concept", "human", output_format=99),
                lambda d, f: d.get_links("Inheritance", output_format=99)):
        for das, f in zip(animals, fmt):
            with pytest.raises(ValueError):
                bad(das, f)


def test_read_surface_getters(animals):
    jx, pt = animals
    h = pt.get_node("Concept", "human")
    m = pt.get_node("Concept", "mammal")
    link = pt.get_link("Inheritance", [h, m])
    for das in animals:
        assert das.get_link_type(link) == "Inheritance"
        assert das.get_link_targets(link) == [h, m]
        assert das.get_node_type(h) == "Concept"
        assert das.get_node_name(h) == "human"
        for fn, arg in ((das.get_link_type, h), (das.get_link_targets, h),
                        (das.get_node_type, link), (das.get_node_name, link)):
            with pytest.raises(ValueError):
                fn(arg)
    n_sim = len(pt.get_links("Similarity"))
    assert n_sim == len(jx.get_links("Similarity")) > 0


def test_black_list_and_clear_database():
    for das, load in ((JxDAS(backend="tensor", config=JxConfig()), jx_animals),
                      (DistributedAtomSpace(backend="tensor", device="cpu"), animals_metta)):
        das.pattern_black_list = ["Similarity"]
        assert das.pattern_black_list == ["Similarity"] == das.data.pattern_black_list
        das.load_metta_text(load())
        h = das.get_node("Concept", "human")
        assert das.get_links("Similarity", targets=[h, "*"]) == []
        assert das.get_links("Inheritance", targets=[h, "*"])
        device = getattr(das.db, "device", None)
        das.clear_database()
        assert das.count_atoms() == (0, 0)
        assert das.pattern_black_list == ["Similarity"]
        assert getattr(das.db, "device", None) == device
        das.load_metta_text(load())
        assert das.count_atoms() == (14, 26)
        das.pattern_black_list = []
        assert len(das.get_links("Similarity", targets=[h, "*"])) == 3
