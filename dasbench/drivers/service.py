"""The `service` driver: closed-loop client threads through
`DasService.query`, the request-dict methods the port's gRPC servicer
adapts (`das_tpu_torch/service/server.py`), on one tenant.

Each client sends its next request as soon as the last one is answered,
with no think time; the requests come, in order, from one list drawn
before the window.  A request is timed on the benchmark's clock, from
just before `query` is called to its return.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

#: the longest a client may still be busy once the window has closed
JOIN_S = 120.0


@dataclass
class Window:
    t_start: float
    t_end: float
    starts: List[Optional[float]]
    ends: List[Optional[float]]
    statuses: List[Optional[dict]]
    exhausted: bool = False
    sent: List[int] = field(default_factory=list)


class Driver:
    def __init__(self, das, traffic: dict):
        from das_tpu_torch.service.server import DasService

        self.svc = DasService(backend=das.config.backend)
        self.key = self.svc.attach_tenant("bench", das)
        self.clients = int(traffic["clients"])
        self.output_format = traffic.get("output_format", "HANDLE")

    def stats(self) -> dict:
        return self.svc.coalescer_stats()

    def _loop(self, requests: List[str], t_end: Optional[float]) -> Window:
        n = len(requests)
        starts: List[Optional[float]] = [None] * n
        ends: List[Optional[float]] = [None] * n
        statuses: List[Optional[dict]] = [None] * n
        taken = itertools.count()
        go = threading.Event()
        exhausted = threading.Event()
        window = {}

        def client():
            go.wait()
            end = window["t_end"]
            while True:
                i = next(taken)
                if i >= n:
                    exhausted.set()
                    return
                t0 = time.perf_counter()
                if end is not None and t0 >= end:
                    return
                st = self.svc.query({"key": self.key, "query": requests[i],
                                     "output_format": self.output_format})
                ends[i] = time.perf_counter()
                starts[i], statuses[i] = t0, st

        threads = [threading.Thread(target=client, name=f"bench-client-{k}", daemon=True)
                   for k in range(self.clients)]
        for t in threads:
            t.start()
        t_start = time.perf_counter()
        window["t_end"] = None if t_end is None else t_start + t_end
        go.set()
        for t in threads:
            t.join(timeout=JOIN_S if t_end is not None else None)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client was still waiting on the service "
                               f"{JOIN_S:.0f} s after the window closed")
        out = Window(t_start, window["t_end"] or time.perf_counter(), starts, ends, statuses,
                     exhausted=exhausted.is_set() and t_end is not None)
        out.sent = [i for i in range(n) if starts[i] is not None]
        return out

    def warm(self, requests: List[str]) -> Window:
        """Send every request of `requests` through the same clients."""
        return self._loop(requests, None)

    def measure(self, requests: List[str], seconds: float) -> Window:
        """Closed loop for `seconds`; clients stop taking requests at the
        close and finish the ones they sent."""
        return self._loop(requests, seconds)
