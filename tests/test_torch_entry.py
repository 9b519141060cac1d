"""The port's pieces under its entry points, against das_tpu on the CPU:

  * the router's host fallback (query/compiler.py `dispatch(..., host=)`):
    the `das` shim's routed classes (compat_torch/das/pattern_matcher),
    whose own `matched` calls the router, answer all 55 queries of the
    regression battery over a MemoryDB, a CPU TensorDB and a 2-slab CPU
    mesh without re-entering themselves, with the answer sets of das_tpu's
    own shim classes (compat/das) over its MemoryDB; a query the device
    path declines, and one whose device attempt overflows, reach
    `host_matched` exactly once, the overflowed answer cleared first;
  * core/hashing.py's StringExpressionHasher, i64_hash_str,
    hex_list_to_i64 and splitmix64 against das_tpu's on seeded inputs;
  * the mesh executor's settle_many / execute_many against dispatch_many +
    settle_many_iter, and their counts against das_tpu's sharded
    executor on 2 devices.

The shim modules are loaded by path under private names, so no `das`
package enters sys.modules here."""

import sys
from pathlib import Path

import numpy as np
import pytest

from das_tpu.core import hashing as jx_hashing
from das_tpu.core.config import DasConfig as JxConfig
from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.parallel import fused_sharded as jx_fs
from das_tpu.parallel.mesh import make_mesh as jx_make_mesh
from das_tpu.parallel.sharded_db import ShardedDB as JxShardedDB
from das_tpu.query import compiler as jx_compiler
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu.storage.memory_db import MemoryDB as JxMemoryDB
from das_tpu_torch.core import hashing
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import CapacityOverflowError
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.parallel import fused_sharded as fs
from das_tpu_torch.parallel.sharded_db import ShardedDB
from das_tpu_torch.query import ast
from das_tpu_torch.query import compiler
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.storage.memory_db import MemoryDB
from das_tpu_torch.storage.tensor_db import TensorDB
from tests.test_differential import canon
from tests.test_torch_compat import load_by_path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import regression_torch  # noqa: E402


PM = load_by_path("compat_torch/das/pattern_matcher/pattern_matcher.py", "_torch_shim_pm")
JX_PM = load_by_path("compat/das/pattern_matcher/pattern_matcher.py", "_jx_shim_pm")


def _discovering(cls):
    """A routed subclass whose matched() gives the router no `host`: the
    router must find `host_matched` on the query itself."""

    def matched(self, db, answer):
        return compiler.dispatch(db, self, answer)

    def host_matched(self, db, answer):
        return cls.matched(self, db, answer)

    return type(cls.__name__, (cls,), {"matched": matched, "host_matched": host_matched})


class _Discovering:
    """PM's namespace with the discovering classes in place of the routed."""
    Node, Variable, TypedVariable = ast.Node, ast.Variable, ast.TypedVariable
    Link = _discovering(ast.Link)
    LinkTemplate = _discovering(ast.LinkTemplate)
    Not, Or, And = _discovering(ast.Not), _discovering(ast.Or), _discovering(ast.And)


def _queries(m):
    return list(regression_torch.first_section(m)) + list(regression_torch.second_section(m))


def _store(kind):
    data = load_metta_text(animals_metta())
    if kind == "memory":
        return MemoryDB(data)
    if kind == "tensor":
        return TensorDB(data, DasConfig(), device="cpu")
    return ShardedDB(data, DasConfig(mesh_shape=(2,)), device="cpu")


def _answer(q, db, pm):
    a = pm.PatternMatchingAnswer()
    matched = q.matched(db, a)
    return bool(matched), a.negation, {canon(x) for x in a.assignments}


@pytest.fixture(scope="module")
def das_tpu_answers():
    db = JxMemoryDB(jx_load(jx_animals()))
    return [_answer(q, db, JX_PM) for q in _queries(JX_PM)]


@pytest.mark.parametrize("kind", ["memory", "tensor", "sharded"])
@pytest.mark.parametrize("classes", ["routed", "discovering"])
def test_routed_classes_answer_without_recursion(das_tpu_answers, kind, classes):
    m = PM if classes == "routed" else _Discovering
    db = _store(kind)
    compiler.reset_route_counts()
    got = [_answer(q, db, ast) for q in _queries(m)]
    assert len(got) == 55
    for i, (a, b) in enumerate(zip(got, das_tpu_answers)):
        assert a == b, f"query {i} differs from das_tpu's shim on {kind}"
    # a MemoryDB answers every query on the host; a device store answers
    # most on its device path
    if kind == "memory":
        assert compiler.ROUTE_COUNTS["host"] >= 55
    else:
        assert compiler.ROUTE_COUNTS["sharded" if kind == "sharded" else "fused"] > 0


def _counting(q):
    calls = []
    real = q.host_matched

    def host_matched(db, answer):
        calls.append(1)
        return real(db, answer)

    q.host_matched = host_matched
    return calls


@pytest.mark.parametrize("kind", ["tensor", "sharded"])
def test_declined_query_reaches_host_matched_once(das_tpu_answers, kind):
    db = _store(kind)
    qs = _queries(PM)
    # the nested List links of the battery: the device path declines them
    for i in (5, 6):
        calls = _counting(qs[i])
        compiler.reset_route_counts()
        assert _answer(qs[i], db, ast) == das_tpu_answers[i]
        assert len(calls) == 1 and compiler.ROUTE_COUNTS["host"] == 1


@pytest.mark.parametrize("kind", ["tensor", "sharded"])
def test_overflowed_attempt_clears_and_reaches_host_matched_once(das_tpu_answers, kind,
                                                                 monkeypatch):
    db = _store(kind)
    i = 35      # And(Inheritance($V1, $V2), Inheritance($V2, $V3))
    q = _queries(PM)[i]

    def overflow(db_, query, answer):
        answer.assignments.add("partial")
        answer.negation = True
        raise CapacityOverflowError("forced")

    if kind == "sharded":
        monkeypatch.setattr(db, "query_sharded", lambda query, answer: overflow(db, query, answer))
    else:
        monkeypatch.setattr(compiler, "query_on_device", overflow)
    calls = _counting(q)
    assert _answer(q, db, ast) == das_tpu_answers[i]
    assert len(calls) == 1


def test_string_expression_hasher_equals_das_tpu():
    a, b = hashing.StringExpressionHasher, jx_hashing.StringExpressionHasher
    assert a.named_type_hash("Concept") == b.named_type_hash("Concept")
    assert a.terminal_hash("Concept", "human") == b.terminal_hash("Concept", "human")
    els = ["<Concept: human>", "<Concept: mammal>"]
    assert a.expression_hash("<Type: Inheritance>", els) == b.expression_hash(
        "<Type: Inheritance>", els)
    for hl in (["x"], ["x", "y", "z"]):
        assert a.composite_hash(hl) == b.composite_hash(hl)
    assert a._compute_hash("abc") == b._compute_hash("abc")


def test_i64_hashes_and_splitmix64_equal_das_tpu():
    rng = np.random.default_rng(17)
    texts = [f"Concept {int(v)}" for v in rng.integers(0, 1 << 40, 64)]
    for t in texts:
        assert hashing.i64_hash_str(t) == jx_hashing.i64_hash_str(t)
    hexes = [hashing.compute_hash(t) for t in texts]
    got, want = hashing.hex_list_to_i64(hexes), jx_hashing.hex_list_to_i64(hexes)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, hashing.hex_to_i64_bulk(hexes))
    # uint64 wraparound: values near 2^64 and int64 views of negatives
    x = np.concatenate([rng.integers(0, 1 << 63, 256, dtype=np.uint64) * np.uint64(2),
                        np.array([0, 1, (1 << 64) - 1, (1 << 64) - 0x9E3779B97F4A7C15],
                                 dtype=np.uint64)])
    before = x.copy()
    got, want = hashing.splitmix64(x), jx_hashing.splitmix64(x)
    assert got.dtype == want.dtype == np.uint64 and np.array_equal(got, want)
    assert np.array_equal(x, before)    # the input is not written
    neg = rng.integers(-(1 << 62), 0, 64, dtype=np.int64)
    assert np.array_equal(hashing.splitmix64(neg), jx_hashing.splitmix64(neg))


@pytest.fixture(scope="module")
def meshes():
    jdb = JxShardedDB(jx_load(jx_animals()), JxConfig(), mesh=jx_make_mesh(2))
    pdb = _store("sharded")
    return jdb, pdb


def _conjunctions(m):
    L, V, N = m.Link, m.Variable, m.Node
    return [
        L("Inheritance", [V("V1"), N("Concept", "mammal")], True),
        m.And([L("Inheritance", [V("V1"), V("V2")], True),
               L("Inheritance", [V("V2"), V("V3")], True)]),
        m.And([L("Inheritance", [V("V1"), V("V3")], True),
               L("Inheritance", [V("V2"), V("V3")], True),
               m.Not(L("Inheritance", [V("V1"), N("Concept", "mammal")], True))]),
    ]


def test_sharded_settle_many_and_execute_many(meshes):
    jdb, pdb = meshes
    from das_tpu.query import ast as jx_ast

    pplans = [compiler.plan_query(pdb, q) for q in _conjunctions(ast)]
    jplans = [jx_compiler.plan_query(jdb, q) for q in _conjunctions(jx_ast)]
    ex, jex = fs.get_sharded_executor(pdb), jx_fs.get_sharded_executor(jdb)
    want = jex.execute_many(jplans)
    assert [w.count for w in want] == [4, 7, 18]
    for count_only in (False, True):
        streamed = [None] * len(pplans)
        for i, res in ex.settle_many_iter(ex.dispatch_many(pplans, count_only)):
            streamed[i] = res
        settled = ex.settle_many(ex.dispatch_many(pplans, count_only))
        executed = ex.execute_many(pplans, count_only)
        for s, t, e, w in zip(streamed, settled, executed, want):
            assert s.count == t.count == e.count == w.count
            assert s.reseed_needed == t.reseed_needed == e.reseed_needed == w.reseed_needed
            if not count_only:
                assert np.array_equal(s.host_vals, e.host_vals)
                assert np.array_equal(s.host_valid, e.host_valid)
