"""Client of the DAS service, a library class and a command line (port of
`das_tpu/service/client.py`): one subcommand per RPC,
``--output-format {HANDLE,DICT,JSON}`` where it applies, printing the
Status message.  One of the port's four modules that import grpc.

    python -m das_tpu_torch.service.client --port 7533 create animals
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import grpc

from das_tpu_torch.service import protocol


class DasClient:
    #: longest single client-side backoff honored from a server
    #: retry-after hint (ms) — a misbehaving hint must not park the
    #: client
    MAX_RETRY_WAIT_MS = 2000

    def __init__(self, host: str = "localhost", port: int = protocol.DEFAULT_PORT):
        from das_tpu_torch.service.service_spec import das_pb2_grpc

        self.channel = grpc.insecure_channel(f"{host}:{port}")
        self._request_types = das_pb2_grpc.RPC_REQUEST_TYPES
        self._stub = das_pb2_grpc.ServiceDefinitionStub(self.channel)

    def call(self, rpc: str, **request) -> Dict:
        # protobuf scalar fields reject None; drop unset optionals
        clean = {k: v for k, v in request.items() if v is not None}
        status = getattr(self._stub, rpc)(self._request_types[rpc](**clean))
        return {"success": status.success, "msg": status.msg}

    def call_with_retry(self, rpc: str, **request) -> Dict:
        """`call`, honoring the server's typed retryable statuses: on a `DAS-RETRY kind=... retry_after_ms=N` failure —
        coalescer saturation, deadline expiry, an open circuit breaker —
        sleep min(N, MAX_RETRY_WAIT_MS) ONCE and retry once.  Exactly
        one bounded backoff: the hint says when capacity should return;
        anything beyond one beat is the caller's policy."""
        result = self.call(rpc, **request)
        if result["success"]:
            return result
        hint = protocol.parse_retryable(result["msg"])
        if hint is None:
            return result
        time.sleep(min(hint["retry_after_ms"], self.MAX_RETRY_WAIT_MS) / 1e3)
        return self.call(rpc, **request)

    def close(self):
        self.channel.close()

    # -- typed conveniences ------------------------------------------------

    def create(self, name: str) -> Dict:
        return self.call("create", name=name)

    def reconnect(self, name: str) -> Dict:
        return self.call("reconnect", name=name)

    def load_knowledge_base(self, key: str, url: str) -> Dict:
        return self.call("load_knowledge_base", key=key, url=url)

    def check_das_status(self, key: str) -> Dict:
        return self.call("check_das_status", key=key)

    def clear(self, key: str) -> Dict:
        return self.call("clear", key=key)

    def count(self, key: str) -> Dict:
        return self.call("count", key=key)

    def get_atom(self, key: str, handle: str, output_format: str = "HANDLE") -> Dict:
        return self.call(
            "get_atom", key=key, handle=handle, output_format=output_format
        )

    def search_nodes(
        self,
        key: str,
        node_type: Optional[str] = None,
        node_name: Optional[str] = None,
        output_format: str = "HANDLE",
    ) -> Dict:
        return self.call(
            "search_nodes",
            key=key,
            node_type=node_type or "",
            node_name=node_name or "",
            output_format=output_format,
        )

    def search_links(
        self,
        key: str,
        link_type: Optional[str] = None,
        target_types: Optional[List[str]] = None,
        targets: Optional[List[str]] = None,
        output_format: str = "HANDLE",
    ) -> Dict:
        return self.call(
            "search_links",
            key=key,
            link_type=link_type or "",
            target_types=target_types,
            targets=targets,
            output_format=output_format,
        )

    def query(self, key: str, query: str, output_format: str = "HANDLE") -> Dict:
        return self.call_with_retry(
            "query", key=key, query=query, output_format=output_format
        )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="DAS service client (PyTorch port)")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=protocol.DEFAULT_PORT)
    sub = ap.add_subparsers(dest="command", required=True)

    def fmt(p):
        p.add_argument(
            "--output-format", default="HANDLE", choices=("HANDLE", "DICT", "JSON")
        )

    sub.add_parser("create").add_argument("name")
    sub.add_parser("reconnect").add_argument("name")
    p = sub.add_parser("load")
    p.add_argument("key")
    p.add_argument("url")
    sub.add_parser("status").add_argument("key")
    sub.add_parser("clear").add_argument("key")
    sub.add_parser("count").add_argument("key")
    p = sub.add_parser("atom")
    p.add_argument("key")
    p.add_argument("handle")
    fmt(p)
    p = sub.add_parser("search-nodes")
    p.add_argument("key")
    p.add_argument("--node-type")
    p.add_argument("--node-name")
    fmt(p)
    p = sub.add_parser("search-links")
    p.add_argument("key")
    p.add_argument("--link-type")
    p.add_argument("--target-types", nargs="*")
    p.add_argument("--targets", nargs="*")
    fmt(p)
    p = sub.add_parser("query")
    p.add_argument("key")
    p.add_argument("query")
    fmt(p)

    args = ap.parse_args(argv)
    client = DasClient(args.host, args.port)
    try:
        if args.command == "create":
            result = client.create(args.name)
        elif args.command == "reconnect":
            result = client.reconnect(args.name)
        elif args.command == "load":
            result = client.load_knowledge_base(args.key, args.url)
        elif args.command == "status":
            result = client.check_das_status(args.key)
        elif args.command == "clear":
            result = client.clear(args.key)
        elif args.command == "count":
            result = client.count(args.key)
        elif args.command == "atom":
            result = client.get_atom(args.key, args.handle, args.output_format)
        elif args.command == "search-nodes":
            result = client.search_nodes(
                args.key, args.node_type, args.node_name, args.output_format
            )
        elif args.command == "search-links":
            result = client.search_links(
                args.key,
                args.link_type,
                args.target_types,
                args.targets,
                args.output_format,
            )
        else:
            result = client.query(args.key, args.query, args.output_format)
    finally:
        client.close()
    print(result.get("msg", ""))
    return 0 if result.get("success") else 1


if __name__ == "__main__":
    raise SystemExit(main())
