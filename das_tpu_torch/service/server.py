"""Multi-tenant DAS service hosting named AtomSpaces (port of
`das_tpu/service/server.py`, without the gRPC wire).

`DasService` implements the 10 RPCs as methods from a request dict to a
`protocol.status` dict; service/transport.py adapts them to gRPC
(`serve`).  This module imports no grpc and no protobuf, so the service
runs wherever the port does, the card machine included, driven through
these methods.

  * **No global lock.**  Each tenant carries its own lock and its own
    query coalescer (service/coalesce.py), created on first use.
  * **Load status.**  A knowledge-base load runs on a thread and moves
    the tenant LOADING -> READY or -> FAILED(msg), seen by
    check_das_status.  Sources: a local path (file or directory of
    .metta files), a ``file://`` URL, or a ``.tgz``/``.tar`` archive of
    those.
  * **Typed retryable statuses** for saturation, deadline expiry and an
    open breaker (`protocol.retryable_status`).

`DasService(backend=, config=, device=)` hands all three to every tenant
it creates; the device defaults to CUDA, which raises without a card, as
every entry point of the port does.  Query RPCs always go through the
tenant's coalescer.  `metrics_text()` is the
Prometheus text of obs/ with the serving gauges of `coalescer_stats()`;
`start_metrics_http` serves it on `GET /metrics`.

    python -m das_tpu_torch.service.server --port 7533 --backend tensor --device cpu

A sharded tenant (`--backend sharded --shards 8`) rides the same
coalescer: its batches take the sharded executor's dispatch and settle
halves, and the sharded routes count in `coalescer_stats()["routes"]`.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import shutil
import string
import tarfile
import tempfile
import threading
import traceback
from concurrent.futures import TimeoutError as FuturesTimeoutError
from enum import Enum
from typing import Dict, Optional

from das_tpu_torch.api.atomspace import DistributedAtomSpace, QueryOutputFormat
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.exceptions import (
    BreakerOpenError,
    CoalescerSaturatedError,
    DasDeadlineError,
)
from das_tpu_torch.service import protocol
from das_tpu_torch.service.query_dsl import parse_query

log = logging.getLogger("das_tpu_torch")

#: the backstop on a coalesced future wait when deadlines are off: the
#: worker resolves every future, so this fires only if the serving loop
#: itself wedged; an RPC thread never blocks forever
_RPC_WAIT_BACKSTOP_S = 600.0


class AtomSpaceStatus(str, Enum):
    READY = "Ready"
    LOADING = "Loading knowledge base"
    FAILED = "Load failed"


_OUTPUT_FORMATS = {
    "HANDLE": QueryOutputFormat.HANDLE,
    "DICT": QueryOutputFormat.ATOM_INFO,
    "JSON": QueryOutputFormat.JSON,
}


def _random_token(length: int = 20) -> str:
    return "".join(random.choice(string.ascii_lowercase) for _ in range(length))


class _Tenant:
    def __init__(self, name: str, das: DistributedAtomSpace):
        self.name = name
        self.das = das
        self.status = AtomSpaceStatus.READY
        self.status_detail = ""
        self.lock = threading.RLock()
        #: per-TENANT query coalescer (service/coalesce.py), created on
        #: first use: tenants never serialize behind each other's batches
        #: (the service's no-global-lock design holds under coalescing)
        self.coalescer = None
        self._coalescer_lock = threading.Lock()

    def get_coalescer(self):
        if self.coalescer is None:
            with self._coalescer_lock:
                if self.coalescer is None:
                    from das_tpu_torch.service.coalesce import QueryCoalescer

                    # the serving knobs come from the tenant's DasConfig
                    cfg = getattr(self.das, "config", None)
                    self.coalescer = QueryCoalescer(
                        max_batch=getattr(cfg, "coalesce_max_batch", None),
                        pipeline_depth=getattr(cfg, "pipeline_depth", None),
                        pipeline_depth_max=getattr(
                            cfg, "pipeline_depth_max", None
                        ),
                        queue_max=getattr(cfg, "coalesce_queue_max", None),
                        deadline_ms=getattr(cfg, "query_deadline_ms", None),
                        breaker_threshold=getattr(
                            cfg, "breaker_failure_threshold", None
                        ),
                        breaker_cooldown_ms=getattr(
                            cfg, "breaker_cooldown_ms", None
                        ),
                    )
        return self.coalescer


class _KnowledgeBaseLoader(threading.Thread):
    """Async KB fetch+load with an explicit failure transition."""

    def __init__(self, tenant: _Tenant, url: str):
        super().__init__(daemon=True)
        self.tenant = tenant
        self.url = url

    def run(self):
        temp_dir = tempfile.mkdtemp()
        try:
            path = self.url
            if path.startswith("file://"):
                path = path[len("file://"):]
            if path.endswith((".tgz", ".tar.gz", ".tar")):
                with tarfile.open(path) as tar:
                    tar.extractall(temp_dir, filter="data")
                source = temp_dir
            else:
                source = path
            with self.tenant.lock:
                self.tenant.das.load_knowledge_base(source)
                self.tenant.status = AtomSpaceStatus.READY
                self.tenant.status_detail = ""
        except Exception as exc:  # noqa: BLE001 — surfaced via status RPC
            log.info(f"KB load failed for '{self.tenant.name}': {exc}")
            self.tenant.status = AtomSpaceStatus.FAILED
            self.tenant.status_detail = str(exc)
        finally:
            shutil.rmtree(temp_dir, ignore_errors=True)


class DasService:
    """RPC method implementations (request dict -> Status dict)."""

    def __init__(self, backend: Optional[str] = None,
                 config: Optional[DasConfig] = None, device=None):
        self.backend = backend
        #: every tenant gets its own copy of this config, and this device
        self.config = config
        self.device = device
        self.tenants: Dict[str, _Tenant] = {}
        self.registry_lock = threading.Lock()
        # a torch.profiler trace over the service's life when the config
        # names a profiler_trace_dir (obs/torchprof.py); stop_trace writes it
        from das_tpu_torch import obs

        obs.maybe_start_trace(config)

    def stop_trace(self) -> bool:
        """Stop the profiler trace the constructor started and write it
        (False when none runs)."""
        from das_tpu_torch import obs

        return obs.maybe_stop_trace()

    def coalescer_stats(self) -> Dict[str, int]:
        """Aggregate serving-path observability (bench/tests): per-tenant
        coalescer counters, the execution pipeline's in-flight high-water
        mark, the result caches' hit/miss/invalidation counters (the
        conjunctive, tree-composite and count-batch caches all fold in),
        the process-wide route counters, the planner's counters and the
        durability counters, and the program ledger's snapshot
        (`programs`, obs/proflog.py).  `tenants` breaks the aggregates down
        per tenant name."""
        out = {
            "batches": 0, "items": 0, "max_batch": 0, "max_batch_limit": 0,
            "pipeline_depth": 0, "pipeline_depth_max": 0,
            "effective_depth": 0, "rtt_ewma_ms": 0.0,
            "dispatch_ewma_ms": 0.0, "inflight_peak": 0,
            "speculative_dispatches": 0, "early_settles": 0,
            "queue_rejections": 0,
            "deadline_expired": 0, "breaker_rejections": 0,
            "breaker_trips": 0, "breaker_recoveries": 0,
            "breaker_open_tenants": 0,
            "cache_hits": 0, "cache_misses": 0, "cache_invalidations": 0,
            "tenants": {},
        }
        for tenant in list(self.tenants.values()):
            per = {
                "backend": getattr(
                    getattr(tenant.das, "config", None), "backend", None
                ),
                "inflight_peak": 0,
            }
            c = tenant.coalescer
            if c is not None:
                snap = c.snapshot()
                out["batches"] += snap["batches"]
                out["items"] += snap["items"]
                out["max_batch"] = max(out["max_batch"], snap["max_batch"])
                out["max_batch_limit"] = max(
                    out["max_batch_limit"], snap["max_batch_limit"]
                )
                out["pipeline_depth"] = max(
                    out["pipeline_depth"], snap["pipeline_depth"]
                )
                out["pipeline_depth_max"] = max(
                    out["pipeline_depth_max"], snap["pipeline_depth_max"]
                )
                # the deepest adaptive window any tenant reached, with
                # BOTH inputs of THAT tenant's ceil(rtt/dispatch) sizing
                # — taking independent maxima across tenants would pair
                # one tenant's wire with another's dispatch cost, a
                # ratio no window actually uses; per-tenant dicts below
                # are the authoritative breakdown.  Without the dispatch
                # EWMA an operator cannot tell "wire is fast" from
                # "dispatch cost inflated" when the window sticks at
                # the floor
                if snap["effective_depth"] >= out["effective_depth"]:
                    out["effective_depth"] = snap["effective_depth"]
                    out["rtt_ewma_ms"] = snap["rtt_ewma_ms"]
                    out["dispatch_ewma_ms"] = snap["dispatch_ewma_ms"]
                out["inflight_peak"] = max(
                    out["inflight_peak"], snap["inflight_peak"]
                )
                out["speculative_dispatches"] += snap["speculative_dispatches"]
                out["early_settles"] += snap["early_settles"]
                out["queue_rejections"] += snap["queue_rejections"]
                # robustness aggregates: deadline misses,
                # degraded-mode rejections and the breaker lifecycle —
                # per-tenant state below tells WHICH tenant is degraded
                out["deadline_expired"] += snap["deadline_expired"]
                out["breaker_rejections"] += snap["breaker_rejections"]
                out["breaker_trips"] += snap["breaker_trips"]
                out["breaker_recoveries"] += snap["breaker_recoveries"]
                if snap["breaker_state"] != "closed":
                    out["breaker_open_tenants"] += 1
                per.update(
                    batches=snap["batches"],
                    items=snap["items"],
                    max_batch=snap["max_batch"],
                    inflight_peak=snap["inflight_peak"],
                    effective_depth=snap["effective_depth"],
                    rtt_ewma_ms=snap["rtt_ewma_ms"],
                    dispatch_ewma_ms=snap["dispatch_ewma_ms"],
                    speculative_dispatches=snap["speculative_dispatches"],
                    early_settles=snap["early_settles"],
                    queue_rejections=snap["queue_rejections"],
                    deadline_expired=snap["deadline_expired"],
                    breaker_state=snap["breaker_state"],
                    breaker_rejections=snap["breaker_rejections"],
                    breaker_trips=snap["breaker_trips"],
                    breaker_recoveries=snap["breaker_recoveries"],
                    # last-K (rtt_ewma, dispatch_ewma, effective_depth)
                    # samples: the window-formula history, per tenant
                    window_history=snap["window_history"],
                )
            db = getattr(tenant.das, "db", None)
            if db is not None:
                from das_tpu_torch.query.fused import result_cache_stats

                cache = result_cache_stats(db)
                out["cache_hits"] += cache["hits"]
                out["cache_misses"] += cache["misses"]
                out["cache_invalidations"] += cache["invalidations"]
                per["cache_hits"] = cache["hits"]
                per["cache_misses"] = cache["misses"]
            out["tenants"][tenant.name] = per
        from das_tpu_torch import planner
        from das_tpu_torch.obs import proflog
        from das_tpu_torch.query.compiler import ROUTE_COUNTS
        from das_tpu_torch.storage import durable

        out["routes"] = dict(ROUTE_COUNTS)
        # planned-vs-greedy traffic, retry rounds planned jobs still paid,
        # and the summed estimated-vs-actual join rows
        out["planner"] = planner.snapshot()
        # the program ledger: first calls and their seconds, the cold
        # start (kernel and scanner builds), the ledger hit rate and the
        # per-site budget-vs-actual bytes
        out["programs"] = proflog.snapshot()
        # active snapshot generation, WAL records appended and replayed,
        # torn-tail truncations, the last restore's wall seconds
        out["durability"] = durable.snapshot_stats()
        return out

    def metrics_text(self) -> str:
        """Prometheus text of the obs metric layer plus the serving
        gauges of coalescer_stats(), the program ledger's and the
        durability gauges: one scrape surface (`start_metrics_http` serves
        it)."""
        from das_tpu_torch import obs

        stats = self.coalescer_stats()
        gauges = {
            f"serving.{k}": float(stats[k])
            for k in (
                "batches", "items", "inflight_peak", "effective_depth",
                "rtt_ewma_ms", "dispatch_ewma_ms",
                "speculative_dispatches", "early_settles",
                "queue_rejections", "deadline_expired",
                "breaker_rejections", "breaker_trips",
                "breaker_recoveries", "breaker_open_tenants",
                "cache_hits", "cache_misses",
                "cache_invalidations",
            )
        }
        progs = stats.get("programs") or {}
        for k in ("compiles", "compile_s", "cold_start_s", "persistent_cache_hits",
                  "ledger_hits"):
            gauges[f"programs.{k}"] = float(progs.get(k) or 0)
        if progs.get("hit_rate") is not None:
            gauges["programs.hit_rate"] = float(progs["hit_rate"])
        dur = stats.get("durability") or {}
        for k in ("generation", "snapshots", "wal_records",
                  "recovery_replayed", "torn_tail_truncations",
                  "corrupt_generations"):
            gauges[f"durability.{k}"] = float(dur.get(k) or 0)
        if dur.get("last_restore_s") is not None:
            gauges["durability.last_restore_s"] = float(
                dur["last_restore_s"]
            )
        return obs.prometheus_text(extra_gauges=gauges)

    # -- helpers -----------------------------------------------------------

    def _new_tenant(self, name: str):
        with self.registry_lock:
            if any(t.name == name for t in self.tenants.values()):
                return None, protocol.status(False, f"DAS named '{name}' already exists")
            token = self._fresh_token()
            kwargs = {"database_name": name, "device": self.device}
            if self.backend:
                kwargs["backend"] = self.backend
            if self.config is not None:
                kwargs["config"] = dataclasses.replace(self.config)
            self.tenants[token] = _Tenant(name, DistributedAtomSpace(**kwargs))
            return token, None

    def _tenant_ready(self, key: str):
        tenant = self.tenants.get(key)
        if tenant is None:
            return None, protocol.status(False, "Invalid DAS key")
        if tenant.status == AtomSpaceStatus.LOADING:
            return None, protocol.status(False, f"DAS {key} is busy")
        return tenant, None

    @staticmethod
    def _map_failure(exc: Exception):
        """Typed retryable statuses: saturation, deadline
        expiry, and breaker rejections each map to a DISTINCT
        machine-parsable status with a retry-after hint
        (protocol.retryable_status) — clients back off and retry
        instead of treating a transient rejection as a hard failure.
        Everything else keeps the generic traceback status."""
        if isinstance(exc, CoalescerSaturatedError):
            return protocol.retryable_status("saturated", 50, str(exc))
        if isinstance(exc, DasDeadlineError):
            # the hint says when capacity may RETURN, which the expired
            # deadline's duration says nothing about — a momentary
            # backlog clears in milliseconds; use the same short beat
            # as saturation rather than parking clients for a full
            # deadline
            return protocol.retryable_status("deadline", 50, str(exc))
        if isinstance(exc, BreakerOpenError):
            hint = getattr(exc, "retry_after_ms", None)
            return protocol.retryable_status(
                "breaker_open", 250 if hint is None else hint, str(exc)
            )
        lines = traceback.format_exc().splitlines()
        return protocol.status(False, f"{exc} {lines}")

    def _call(self, key: str, method: str, args: list):
        tenant, err = self._tenant_ready(key)
        if err:
            return err
        try:
            with tenant.lock:
                answer = getattr(tenant.das, method)(*args)
        except Exception as exc:  # noqa: BLE001 — RPC surface, never raise
            return self._map_failure(exc)
        return protocol.status(True, answer)

    @staticmethod
    def _format(request) -> QueryOutputFormat:
        return _OUTPUT_FORMATS.get(
            request.get("output_format", "HANDLE"), QueryOutputFormat.HANDLE
        )

    # -- the 10 RPCs -------------------------------------------------------

    def create(self, request):
        token, err = self._new_tenant(request.get("name", ""))
        return err if err else protocol.status(True, token)

    def reconnect(self, request):
        # same semantics as create for a stateless-storage deployment: a
        # fresh token bound to the named space
        token, err = self._new_tenant(request.get("name", ""))
        return err if err else protocol.status(True, token)

    def load_knowledge_base(self, request):
        key = request.get("key", "")
        # atomic check-then-set: two concurrent loads on one key must not
        # both pass the LOADING guard
        with self.registry_lock:
            tenant, err = self._tenant_ready(key)
            if err:
                return err
            tenant.status = AtomSpaceStatus.LOADING
        _KnowledgeBaseLoader(tenant, request.get("url", "")).start()
        return protocol.status(True, AtomSpaceStatus.LOADING.value)

    def check_das_status(self, request):
        tenant = self.tenants.get(request.get("key", ""))
        if tenant is None:
            return protocol.status(False, "Invalid DAS key")
        msg = tenant.status.value
        if tenant.status_detail:
            msg = f"{msg}: {tenant.status_detail}"
        return protocol.status(True, msg)

    def clear(self, request):
        return self._call(request.get("key", ""), "clear_database", [])

    def count(self, request):
        return self._call(request.get("key", ""), "count_atoms", [])

    def get_atom(self, request):
        return self._call(
            request.get("key", ""),
            "get_atom",
            [request.get("handle", ""), self._format(request)],
        )

    def search_nodes(self, request):
        return self._call(
            request.get("key", ""),
            "get_nodes",
            [
                request.get("node_type") or None,
                request.get("node_name") or None,
                self._format(request),
            ],
        )

    def search_links(self, request):
        return self._call(
            request.get("key", ""),
            "get_links",
            [
                request.get("link_type") or None,
                request.get("target_types") or None,
                request.get("targets") or None,
                self._format(request),
            ],
        )

    def query(self, request):
        query = parse_query(request.get("query", ""))
        if query is None:
            return protocol.status(False, "Invalid query")
        # serving-edge query coalescing: concurrent singles batch into one
        # dispatch and one fetch, PER TENANT (service/coalesce.py)
        tenant, err = self._tenant_ready(request.get("key", ""))
        if err:
            return err
        coalescer = tenant.get_coalescer()
        future = coalescer.submit(tenant, query, self._format(request))
        # BOUNDED wait: the worker resolves every future
        # (deadline expiry included), so the timeout is a backstop —
        # with a deadline configured it tracks it with slack, and
        # even with deadlines off no RPC thread blocks forever
        deadline_ms = coalescer.deadline_ms
        timeout = (
            deadline_ms / 1e3 * 2 + 30.0
            if deadline_ms > 0 else _RPC_WAIT_BACKSTOP_S
        )
        try:
            return protocol.status(True, future.result(timeout=timeout))
        except FuturesTimeoutError:
            future.cancel()
            return self._map_failure(
                DasDeadlineError(
                    "coalesced query timed out at the RPC wait "
                    "backstop", deadline_ms=deadline_ms,
                )
            )
        except Exception as exc:  # noqa: BLE001 — RPC surface
            return self._map_failure(exc)

    # -- test/bench plumbing ----------------------------------------------

    def attach_tenant(self, name: str, das) -> str:
        """Register an already-constructed DistributedAtomSpace as a tenant
        (tests and benches attach a pre-built store instead of re-loading
        through the create+load RPCs).  Same registry rules as create."""
        with self.registry_lock:
            if any(t.name == name for t in self.tenants.values()):
                raise ValueError(f"DAS named '{name}' already exists")
            token = self._fresh_token()
            self.tenants[token] = _Tenant(name, das)
            return token

    def _fresh_token(self) -> str:
        """Caller holds registry_lock."""
        while True:
            token = _random_token()
            if token not in self.tenants:
                return token


def start_metrics_http(service: DasService, port: int):
    """Prometheus text-exposition endpoint (`GET /metrics`) on a daemon
    thread — stdlib http.server, no new dependency.  Returns the bound
    HTTPServer (`.server_port` for port-0 tests)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = service.metrics_text().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes must not spam stderr
            pass

    httpd = HTTPServer(("0.0.0.0", port), _Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    log.info(f"metrics exposition on port {httpd.server_port}")
    return httpd



if __name__ == "__main__":
    # `python -m das_tpu_torch.service.server`: the gRPC service
    # (service/transport.py serve), blocking.  The transport is imported
    # here only, so importing this module never loads grpc.
    import argparse

    from das_tpu_torch.service.transport import serve

    ap = argparse.ArgumentParser(description="DAS gRPC service (PyTorch port)")
    ap.add_argument("--port", type=int, default=protocol.DEFAULT_PORT)
    ap.add_argument("--backend", default=None, help="memory | tensor | sharded")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--shards", type=int, default=None,
                    help="slabs of a sharded tenant (default: one per card)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve GET /metrics on this port (0 = none)")
    args = ap.parse_args()
    config = DasConfig(mesh_shape=(args.shards,)) if args.shards else None
    serve(port=args.port, backend=args.backend, device=args.device, config=config,
          metrics_port=args.metrics_port)
