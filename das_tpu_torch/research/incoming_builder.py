"""Incoming/outgoing sets built over a KV store, through the cache.

Role of reference das/research/das_couch_cached.py:39-140: stream
every link, upsert its outgoing set, and APPEND it to each target's
incoming set via the cached client (read-modify-write with set-dedup) —
the workload the 20 MB-value workaround existed for.  Instrumented with
the same Clock/Statistics accumulators (utils/timing.py).

In the port the real incoming index is the finalized device CSR
(storage/atom_table.py); this module exists as the legacy-path analogue
and as a host-side differential oracle: tests assert its KV output
matches the CSR exactly.
"""

from __future__ import annotations

from typing import Dict, Tuple

from das_tpu_torch.research.cache import (
    AbstractKVClient,
    CachedKVClient,
    DocumentNotFoundException,
)
from das_tpu_torch.utils.timing import Clock, Statistics

INCOMING_PREFIX = "incoming:"
OUTGOING_PREFIX = "outgoing:"


def _append(cached: CachedKVClient, key: str, new_values) -> int:
    """Reference `append` (das_couch_cached.py:39-56): read-extend-dedup-
    write through the cache; returns the new set size."""
    value = []
    try:
        value = cached.get(key)
    except DocumentNotFoundException:
        pass
    value.extend(new_values)
    v = sorted(set(value))
    cached.add(key=key, value=v, size=len(v))
    return len(v)


def populate_sets(
    data, kv_client: AbstractKVClient, cache_limit: int = 10_000_000
) -> Dict[str, Statistics]:
    """Build `outgoing:<link>` and `incoming:<atom>` sets for every link
    record in the store, incoming through the write-back cache (reference
    populate_sets, das_couch_cached.py:59-140).  Returns the timing/size
    statistics the reference logged."""
    incoming_cached = CachedKVClient(kv_client, limit=cache_limit)
    stats = {
        "incoming_time_ms": Statistics(),
        "outgoing_time_ms": Statistics(),
        "incoming_size": Statistics(),
        "outgoing_size": Statistics(),
    }
    clock = Clock()
    for handle, rec in data.links.items():
        clock.start()
        outgoing = sorted(set(rec.elements))
        kv_client.add(OUTGOING_PREFIX + handle, outgoing)
        stats["outgoing_time_ms"].add(clock.elapsed() * 1e3)
        stats["outgoing_size"].add(len(outgoing))

        incoming_batch: Dict[str, list] = {}
        for element in rec.elements:
            incoming_batch.setdefault(element, []).append(handle)
        clock.start()
        for key, values in incoming_batch.items():
            size = _append(incoming_cached, INCOMING_PREFIX + key, values)
            stats["incoming_size"].add(size)
        stats["incoming_time_ms"].add(clock.elapsed() * 1e3)
    incoming_cached.flush()
    return stats


def read_sets(kv_client: AbstractKVClient, handle: str) -> Tuple[list, list]:
    """(outgoing, incoming) of one atom, empty lists when absent."""
    try:
        outgoing = kv_client.get(OUTGOING_PREFIX + handle)
    except DocumentNotFoundException:
        outgoing = []
    try:
        incoming = kv_client.get(INCOMING_PREFIX + handle)
    except DocumentNotFoundException:
        incoming = []
    return outgoing, incoming
