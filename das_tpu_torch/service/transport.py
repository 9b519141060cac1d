"""The gRPC wire of the DAS service (port of the transport half of
`das_tpu/service/server.py`): protobuf request messages become the
request dicts `DasService` takes, and its status dicts become `Status`
messages (service_spec/das.proto).

With service/client.py and service_spec/das_pb2.py / das_pb2_grpc.py this
is one of the four modules of the port that import grpc or protobuf; the
service itself (service/server.py) imports neither, so a machine without
grpcio runs it through `DasService`'s methods.

    serve(port=7533, backend="tensor", device="cpu", block=False)
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Optional

import grpc

from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.service import protocol
from das_tpu_torch.service.server import DasService, start_metrics_http

log = logging.getLogger("das_tpu_torch")


def _message_to_dict(msg) -> dict:
    """Protobuf request message -> the plain request dict the RPC
    implementations take (repeated fields become lists)."""
    out = {}
    for f in msg.DESCRIPTOR.fields:
        value = getattr(msg, f.name)
        # newer protobuf runtimes have .is_repeated, older ones only .label
        repeated = (
            f.is_repeated
            if hasattr(f, "is_repeated")
            else f.label == f.LABEL_REPEATED
        )
        out[f.name] = list(value) if repeated else value
    return out


def _make_servicer(service: DasService):
    """One ServiceDefinitionServicer subclass whose methods adapt protobuf
    messages to the dict-based RPC implementations of `service`."""
    from das_tpu_torch.service.service_spec import das_pb2, das_pb2_grpc

    def adapt(method):
        def call(request, context):
            d = method(_message_to_dict(request))
            return das_pb2.Status(success=d["success"], msg=d["msg"])

        return staticmethod(call)

    methods = {
        rpc: adapt(getattr(service, rpc))
        for rpc in das_pb2_grpc.RPC_REQUEST_TYPES
    }
    servicer_cls = type(
        "DasServicer", (das_pb2_grpc.ServiceDefinitionServicer,), methods
    )
    return servicer_cls()


def serve(
    port: int = protocol.DEFAULT_PORT,
    backend: Optional[str] = None,
    max_workers: int = 10,
    block: bool = True,
    device=None,
    config: Optional[DasConfig] = None,
    metrics_port: int = 0,
):
    """Start the gRPC service; returns (grpc_server, DasService).

    `metrics_port` (0 = none) opens `GET /metrics` and turns the metric
    layer on: every counter site sits behind `obs.enabled()`, so an
    endpoint over a disabled recorder would serve zeros."""
    from das_tpu_torch import obs
    from das_tpu_torch.service.service_spec import das_pb2_grpc

    service = DasService(backend=backend, config=config, device=device)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    das_pb2_grpc.add_ServiceDefinitionServicer_to_server(
        _make_servicer(service), server
    )
    bound = server.add_insecure_port(f"[::]:{port}")
    server.bound_port = bound  # an ephemeral-port caller reads this back
    if metrics_port > 0:
        if not obs.enabled():
            obs.configure(enabled=True)
        server.metrics_http = start_metrics_http(service, metrics_port)
    server.start()
    log.info(f"DAS service listening on port {bound}")
    if block:
        server.wait_for_termination()
        service.stop_trace()
    return server, service
