"""The port's service (das_tpu_torch/service/) against das_tpu's: the
walkthrough of tests/test_service.py on the animals KB through
`DasService` request dicts — create, load, status, count, get_atom,
search_nodes, search_links, DSL queries, invalid key, bad query, a failed
load, clear — gives the same status dicts with the tokens masked (the port
on its tensor backend, device="cpu"; das_tpu on its memory backend, which
compiles nothing).  Then the query DSL against das_tpu's parser, the
typed retryable statuses, the metrics surface, a tenant's own config and
device, one gRPC round trip through the port's `serve()` and `DasClient`,
and a seeded checkpoint."""

import re
import threading
import time
import urllib.request

import pytest

from das_tpu import fault as jx_fault
from das_tpu.core.exceptions import BreakerOpenError as JxBreakerOpenError
from das_tpu.core.exceptions import CoalescerSaturatedError as JxSaturated
from das_tpu.core.exceptions import DasDeadlineError as JxDeadline
from das_tpu.service import protocol as jx_protocol
from das_tpu.service import query_dsl as jx_dsl
from das_tpu.service.server import DasService as JxService
from das_tpu_torch import fault, obs
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import (
    BreakerOpenError,
    CoalescerSaturatedError,
    DasDeadlineError,
)
from das_tpu_torch.models.animals import write_animals_metta
from das_tpu_torch.service import protocol, query_dsl
from das_tpu_torch.service.server import DasService

HUMAN = "af12f10f9ae2002a1607ba0b47ba8407"  # Concept:human

QUERIES = [
    "Node n1 Concept human, Link Inheritance n1 $1",
    "Link Inheritance $1 $2, Link Inheritance $2 $3, AND",
    "Node n1 Concept mammal, Link Inheritance $1 n1, Link Inheritance $1 $2, AND",
    "Node n1 Concept mammal, Link Inheritance $1 n1, Node n2 Concept human",
    "Node n1 Concept mammal, Link Inheritance $1 n1, Link Similarity $1 $2, NOT, AND",
    "Node n1 Concept human, Link Similarity n1 $1, Link Inheritance n1 $1, OR",
]


@pytest.fixture(autouse=True)
def _clean():
    yield
    fault.configure(None)
    fault.reset_counts()
    jx_fault.configure(None)
    obs.reset()
    obs.configure(enabled=False)


@pytest.fixture(scope="module")
def kb(tmp_path_factory):
    return write_animals_metta(str(tmp_path_factory.mktemp("kb") / "animals.metta"))


def _wait_ready(svc, key):
    for _ in range(400):
        st = svc.check_das_status({"key": key})
        if st["msg"] != "Loading knowledge base":
            return st
        time.sleep(0.02)
    pytest.fail("KB load did not finish")


def _answer(status):
    """A query status with its answer as a set: the NOT tag and the sorted
    innermost dicts (an answer is a set of assignments, printed in the
    set's order, which differs between the packages)."""
    msg = status["msg"]
    if not status["success"] or not msg.startswith(("{", "[", "NOT ")):
        return status
    return {"success": True,
            "msg": (msg.startswith("NOT "), sorted(re.findall(r"\{[^{}]*\}", msg)))}


def _walk(svc, kb):
    """The walkthrough's status dicts, tokens masked, answers as sets."""
    out = []
    key = svc.create({"name": "animals"})
    tokens = {key["msg"]: "<key>"}
    out.append(key)
    key = key["msg"]
    out.append(svc.create({"name": "animals"}))
    out.append(svc.load_knowledge_base({"key": key, "url": f"file://{kb}"}))
    out.append(_wait_ready(svc, key))
    out.append(svc.count({"key": key}))
    for fmt in ("HANDLE", "DICT", "JSON"):
        out.append(svc.get_atom({"key": key, "handle": HUMAN, "output_format": fmt}))
        out.append(svc.search_nodes({"key": key, "node_type": "Concept", "node_name": "human",
                                     "output_format": fmt}))
    out.append(svc.search_nodes({"key": key, "node_type": "Concept"}))
    out.append(svc.search_links({"key": key, "link_type": "Inheritance",
                                 "targets": [HUMAN, "*"]}))
    out.append(svc.search_links({"key": key, "link_type": "Similarity",
                                 "target_types": ["Concept", "Concept"], "output_format": "DICT"}))
    for q in QUERIES:
        out.append(_answer(svc.query({"key": key, "query": q})))
    out.append(_answer(svc.query({"key": key, "query": QUERIES[0], "output_format": "DICT"})))
    out.append(svc.count({"key": "nonsense"}))
    out.append(svc.query({"key": key, "query": "Bogus stuff here"}))
    out.append(svc.query({"key": "nonsense", "query": QUERIES[0]}))
    bad = svc.create({"name": "failing"})
    tokens[bad["msg"]] = "<bad>"
    out.append(svc.load_knowledge_base({"key": bad["msg"], "url": "file:///does/not/exist.metta"}))
    st = _wait_ready(svc, bad["msg"])
    out.append(st["msg"].split(":")[0])
    clr = svc.create({"name": "clearable"})["msg"]
    tokens[clr] = "<clr>"
    svc.load_knowledge_base({"key": clr, "url": f"file://{kb}"})
    _wait_ready(svc, clr)
    out.append(svc.clear({"key": clr}))
    out.append(svc.count({"key": clr}))

    def mask(x):
        if isinstance(x, dict):
            return {k: mask(v) for k, v in x.items()}
        if isinstance(x, str):
            for t, m in tokens.items():
                x = x.replace(t, m)
        return x

    return [mask(x) for x in out]


def test_walkthrough_equals_das_tpu(kb):
    got = _walk(DasService(backend="tensor", device="cpu"), kb)
    want = _walk(JxService(backend="memory"), kb)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    assert got[0] == {"success": True, "msg": "<key>"}
    assert got[4] == {"success": True, "msg": "(14, 26)"}
    assert sum(isinstance(g["msg"], tuple) and bool(g["msg"][1]) for g in got[14:20]) >= 4


def test_query_dsl_equals_das_tpu():
    for q in QUERIES + ["", "Node n1 Concept", "Link Inheritance n9 $1", "AND",
                        "Link Inheritance $1 $2, Link Inheritance $2 $3",
                        "Link Similarity $1 $2"]:
        got, want = query_dsl.parse_query(q), jx_dsl.parse_query(q)
        assert (got is None) == (want is None), q
        if got is not None:
            assert repr(got) == repr(want), q


def test_typed_retryable_statuses_equal_das_tpu():
    cases = [(CoalescerSaturatedError("full"), JxSaturated("full")),
             (DasDeadlineError(deadline_ms=5), JxDeadline(deadline_ms=5)),
             (BreakerOpenError(retry_after_ms=120), JxBreakerOpenError(retry_after_ms=120)),
             (BreakerOpenError(), JxBreakerOpenError())]
    for exc, jexc in cases:
        got, want = DasService._map_failure(exc), JxService._map_failure(jexc)
        assert got == want
        assert protocol.parse_retryable(got["msg"]) == jx_protocol.parse_retryable(want["msg"])
    assert protocol.parse_retryable("plain failure") is None
    with pytest.raises(ValueError):
        protocol.retryable_status("nope", 1)


def test_coalescer_stats_and_metrics_surface(kb):
    obs.configure(enabled=True)
    svc = DasService(backend="tensor", device="cpu")
    jsvc = JxService(backend="memory")
    keys = []
    for s in (svc, jsvc):
        k = s.create({"name": "animals"})["msg"]
        s.load_knowledge_base({"key": k, "url": f"file://{kb}"})
        _wait_ready(s, k)
        keys.append(k)
    outs = []

    def client(i):
        outs.append(svc.query({"key": keys[0], "query": QUERIES[i % 3]}))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(outs) == 12 and all(o["success"] for o in outs)
    jsvc.query({"key": keys[1], "query": QUERIES[0]})
    stats, jstats = svc.coalescer_stats(), jsvc.coalescer_stats()
    # "programs" included: the program ledger's snapshot (obs/proflog.py)
    assert set(stats) == set(jstats)
    assert set(stats["programs"]) == set(jstats["programs"])
    assert (set(stats["tenants"]["animals"])
            == set(jstats["tenants"]["animals"]))
    assert stats["items"] == 12 and stats["batches"] >= 1
    text = svc.metrics_text()
    for gauge in ("serving_batches", "serving_items", "serving_inflight_peak",
                  "serving_effective_depth", "durability_generation"):
        assert f"das_tpu_obs_{gauge} " in text, gauge
    assert "das_tpu_obs_serve_answers_total 12" in text
    from das_tpu_torch.service.server import start_metrics_http

    httpd = start_metrics_http(svc, 0)
    try:
        with urllib.request.urlopen(
                f"http://localhost:{httpd.server_port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert "das_tpu_obs_serving_items 12" in body


def test_config_and_device_per_tenant(kb):
    cfg = DasConfig(result_cache_size=0)
    svc = DasService(backend="tensor", device="cpu", config=cfg)
    key = svc.create({"name": "animals"})["msg"]
    svc.load_knowledge_base({"key": key, "url": f"file://{kb}"})
    _wait_ready(svc, key)
    jsvc = JxService(backend="memory")
    jkey = jsvc.create({"name": "animals"})["msg"]
    jsvc.load_knowledge_base({"key": jkey, "url": f"file://{kb}"})
    _wait_ready(jsvc, jkey)
    for q in QUERIES:
        assert (_answer(svc.query({"key": key, "query": q}))
                == _answer(jsvc.query({"key": jkey, "query": q})))
    tenant = svc.tenants[key]
    # every query that parses is served through the tenant's coalescer
    parsed = sum(query_dsl.parse_query(q) is not None for q in QUERIES)
    assert parsed < len(QUERIES) and tenant.coalescer.snapshot()["items"] == parsed
    assert tenant.das.config is not cfg and tenant.das.config.result_cache_size == 0
    assert str(tenant.das.db.dev.device) == "cpu"


def test_grpc_round_trip(kb):
    pytest.importorskip("grpc")
    import socket

    from das_tpu_torch.service.client import DasClient, main as client_main
    from das_tpu_torch.service.transport import serve

    def free_port():
        sock = socket.socket()
        sock.bind(("", 0))
        port = sock.getsockname()[1]
        sock.close()
        return port

    port, mport = free_port(), free_port()
    server, svc = serve(port=port, backend="tensor", device="cpu", block=False,
                        metrics_port=mport)
    client = DasClient("localhost", port)
    try:
        key = client.create("animals")["msg"]
        assert client.load_knowledge_base(key, f"file://{kb}")["success"]
        for _ in range(400):
            if client.check_das_status(key)["msg"] == "Ready":
                break
            time.sleep(0.02)
        assert client.count(key) == {"success": True, "msg": "(14, 26)"}
        want = svc.query({"key": key, "query": QUERIES[0]})
        assert client.query(key, QUERIES[0]) == want
        assert re.search(r"\$1", want["msg"])
        links = client.search_links(key, link_type="Inheritance", targets=[HUMAN, "*"])
        assert links == svc.search_links({"key": key, "link_type": "Inheritance",
                                          "targets": [HUMAN, "*"]})
        assert client_main(["--port", str(port), "count", key]) == 0
        assert client_main(["--port", str(port), "count", "nonsense"]) == 1
        assert obs.enabled()  # asking for the endpoint turned the metric layer on
        with urllib.request.urlopen(f"http://localhost:{mport}/metrics", timeout=10) as resp:
            assert "das_tpu_obs_serving_items 2" in resp.read().decode()  # two queries
    finally:
        client.close()
        server.metrics_http.shutdown()
        server.metrics_http.server_close()
        server.stop(0)


def test_seed_checkpoint(tmp_path, capsys):
    from das_tpu_torch.api.atomspace import DistributedAtomSpace
    from das_tpu_torch.service.seed_checkpoint import seed

    seed(str(tmp_path / "kb"), device="cpu")
    seed(str(tmp_path / "kb"), device="cpu")
    out = capsys.readouterr().out
    assert "seeded" in out and "already present" in out
    das = DistributedAtomSpace(backend="tensor", device="cpu",
                               config=DasConfig(checkpoint_path=str(tmp_path / "kb")))
    assert das.count_atoms() == (14, 26)
