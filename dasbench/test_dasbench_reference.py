"""The NumPy reference equals the port on a tiny KB on the CPU, family by
family, through the service the benchmark drives; and the control does
not.  (The test imports both; the reference never imports the port.)"""

import importlib

import numpy as np
import pytest

from dasbench import bio
from dasbench import kb as kbmod
from dasbench.reference import check as checker
from dasbench.reference.index import LinkIndex

FAMILIES = ("grounded", "grounded_not", "grounded_star", "same_process")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.service.server import DasService

    from dasbench.conftest import TINY

    # few processes, so that two uniform genes often share one (same_process)
    kb = bio.flybase(dict(TINY, n_processes=40, members_per_gene=10), 2**31 + 3)
    path = tmp_path_factory.mktemp("kb") / "kb.metta"
    kbmod.write_canonical(kb, str(path))
    das = DistributedAtomSpace(backend="tensor", device="cpu")
    das.load_canonical_knowledge_base(str(path))
    assert das.count_atoms() == kb.counts()
    svc = DasService(backend="tensor", device="cpu")
    return kb, svc, svc.attach_tenant("t", das)


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_equals_the_port(store, name):
    kb, svc, key = store
    family = importlib.import_module(f"dasbench.reference.{name}")
    ix = LinkIndex(kb)
    params = [tuple(int(x) for x in p) for p in family.draw(kb, ix, np.random.default_rng(5), 48)]
    statuses = [svc.query({"key": key, "query": family.dsl(kb, p)}) for p in params]
    requests = [(0, p) for p in params]
    every = list(range(len(params)))
    handles = checker.HandleMap(kb)
    result = checker.check(kb, [family], requests, statuses, every, every, handles, ix)
    assert result["wrong_answers"] == 0 and result["unanswered"] == 0, result
    assert result["nonempty"] > 0
    control = [{"success": True, "msg": checker.render(family.answer(LinkIndex(kb, bits=8), p),
                                                       family.VARS, handles)} for p in params]
    bad = checker.check(kb, [family], requests, control, every, every, handles, ix)
    assert bad["wrong_answers"] > 0


def test_parse_reads_the_service_format():
    kb = bio.flybase(dict(n_genes=10, n_processes=5, members_per_gene=2, n_interactions=4), 1)
    handles = checker.HandleMap(kb)
    g, p = handles.handle("Gene", 3), handles.handle("BiologicalProcess", 4)
    msg = "{{'$V2': '%s', '$V3': '%s'}}" % (g, p)
    assert checker.parse(msg, ("$V2", "$V3"), handles) == {(("Gene", 3), ("BiologicalProcess", 4))}
    assert checker.parse("", ("$V2", "$V3"), handles) == set()
    assert checker.parse(msg, ("$V1",), handles) is None
    assert checker.parse(msg.replace(g, "0" * 32), ("$V2", "$V3"), handles) is None
    g2 = handles.handle("Gene", 5)
    two = "{{'$V2': '%s', '$V3': '%s'}, {'$V2': '%s', '$V3': '%s'}}" % (g, p, g2, p)
    mixed = "{{'$V2': '%s', '$V3': '%s'}, {'$V3': '%s', '$V2': '%s'}}" % (g, p, p, g2)
    want = {(("Gene", 3), ("BiologicalProcess", 4)), (("Gene", 5), ("BiologicalProcess", 4))}
    assert checker.parse(two, ("$V2", "$V3"), handles) == want
    assert checker.parse(mixed, ("$V2", "$V3"), handles) == want
    assert checker.parse(two.replace(g2, "f" * 32), ("$V2", "$V3"), handles) is None
    assert checker.parse("{{'$V2': '%s'}}" % g, ("$V2", "$V3"), handles) is None
