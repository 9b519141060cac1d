"""Wire protocol of the DAS service edge (port of
`das_tpu/service/protocol.py`).

The 10-RPC contract of service_spec/das.proto — create, reconnect,
load_knowledge_base, check_das_status, clear, count, get_atom,
search_nodes, search_links, query — every RPC returning
``Status{success, msg}``.  Inside the server requests are plain dicts and
responses are `status()` dicts; service/transport.py converts them to and
from the protobuf messages.  This module imports no grpc or protobuf.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

SERVICE_NAME = "das.ServiceDefinition"
DEFAULT_PORT = 7025

# The authoritative request/response schema is service_spec/das.proto;
# the rpc -> message-type map is service_spec/das_pb2_grpc.RPC_REQUEST_TYPES.


def status(success: bool, msg: Any) -> Dict[str, Any]:
    """The universal response message (proto `Status`, das.proto:44-47)."""
    return {"success": bool(success), "msg": str(msg)}


#: typed retryable failure statuses: the server maps
#: saturation / deadline / breaker rejections onto these kinds instead
#: of a generic failure string, carried INSIDE Status.msg so the
#: 10-RPC wire contract stays byte-compatible.  Clients
#: (service/client.py) parse the prefix and honor the retry-after hint
#: with ONE bounded backoff.
RETRYABLE_PREFIX = "DAS-RETRY"
RETRY_KINDS = ("saturated", "deadline", "breaker_open")

_RETRY_RE = re.compile(
    rf"^{RETRYABLE_PREFIX} kind=(?P<kind>[a-z_]+) "
    r"retry_after_ms=(?P<retry_after_ms>\d+)(?: (?P<detail>.*))?$",
    re.DOTALL,
)


def retryable_status(kind: str, retry_after_ms: float,
                     detail: str = "") -> Dict[str, Any]:
    """A failed Status whose msg is a machine-parsable retryable marker:
    `DAS-RETRY kind=<kind> retry_after_ms=<int> <detail>`."""
    if kind not in RETRY_KINDS:
        raise ValueError(f"unknown retryable status kind {kind!r}")
    msg = (
        f"{RETRYABLE_PREFIX} kind={kind} "
        f"retry_after_ms={max(0, int(retry_after_ms))}"
    )
    if detail:
        msg = f"{msg} {detail}"
    return {"success": False, "msg": msg}


def parse_retryable(msg: str) -> Optional[Dict[str, Any]]:
    """{kind, retry_after_ms, detail} when `msg` is a retryable status
    marker, else None — the client-side half of the contract."""
    m = _RETRY_RE.match(msg or "")
    if m is None:
        return None
    return {
        "kind": m.group("kind"),
        "retry_after_ms": int(m.group("retry_after_ms")),
        "detail": m.group("detail") or "",
    }


def method_path(rpc: str) -> str:
    return f"/{SERVICE_NAME}/{rpc}"
