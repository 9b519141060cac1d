"""Size-bounded write-back KV cache.

Role of reference das/research/cache.py:20-109: the research
layer's workaround for slow Couchbase upserts — hold the largest values
in a budgeted in-memory cache (min-heap eviction by size: the SMALLEST
cached value is flushed first, so the entries that are most expensive to
re-upsert stay resident) and write through only when a value is bigger
than the whole budget or smaller than everything already cached.

The port carries the same algebra over an abstract KV client (the
concrete backend is any store with add/get — the reference bound it to a
Couchbase collection).  The tensor store made the original use case
obsolete (incoming sets are a device CSR with no 20 MB value limit), but
the cache remains a usable host-side batching utility and the
differential oracle for tests/test_torch_research.py.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Dict

from das_tpu_torch.research.heap import Heap, PrioritizedItem


class CacheException(Exception):
    pass


class DocumentNotFoundException(CacheException):
    pass


class AbstractKVClient(ABC):
    """The two-method store surface the cache fronts (reference
    AbstractCouchbaseClient)."""

    @abstractmethod
    def add(self, key: str, value: Any) -> None: ...

    @abstractmethod
    def get(self, key: str) -> Any: ...


class FakeKVClient(AbstractKVClient):
    """In-memory fake (reference FakeCouchbaseClient) — returns deep
    copies so callers can't mutate the store through reads, and counts
    writes so tests can assert write-back batching."""

    def __init__(self):
        self.d: Dict[str, Any] = {}
        self.total_add_calls = 0

    def add(self, key: str, value: Any) -> None:
        self.total_add_calls += 1
        self.d[key] = value

    def get(self, key: str) -> Any:
        if key in self.d:
            return deepcopy(self.d[key])
        raise DocumentNotFoundException(key)


class CachedKVClient:
    """Write-back cache with a size budget (reference
    CachedCouchbaseClient, same observable behavior):

    * a value larger than the whole budget — or smaller than the current
      minimum — writes straight through;
    * otherwise it enters the heap, evicting smallest-first until the
      budget holds (evictions are the deferred writes);
    * `get` prefers the cached copy; `flush` writes everything back.
    """

    def __init__(self, kv_client: AbstractKVClient, limit: int):
        self.kv_client = kv_client
        self.heap = Heap()
        self.limit = limit
        self.current_size = 0

    def remove_until_below_limit(self, delta: int) -> None:
        while self.current_size + delta > self.limit:
            item = self.heap.heap_pop()
            self.current_size -= item.size
            self.kv_client.add(item.key, item.value)

    def add(self, key: str, value: Any, size: int) -> None:
        # Departure from the reference (its add, cache.py:73-97, carries
        # two latent bugs this class must not inherit because the
        # incoming-set build is promoted as a differential oracle):
        # an existing entry under `key` is DETACHED first, so
        #   (a) the eviction pass can never pop the key being updated
        #       (ref: KeyError from get_idx_by_key after self-eviction);
        #   (b) a write-through can never leave a stale cached copy whose
        #       later flush would clobber the newer backend value.
        if self.heap.contains(key):
            old_item = self.heap.remove_by_key(key)
            self.current_size -= old_item.size

        if (self.heap and size < self.heap[0].size) or size > self.limit:
            self.kv_client.add(key, value)
            return

        if self.current_size + size > self.limit:
            self.remove_until_below_limit(size)
        self.heap.heap_push(PrioritizedItem(key=key, value=value, size=size))
        self.current_size += size

    def flush(self) -> None:
        for item in self.heap:
            self.kv_client.add(item.key, item.value)
        self.heap = Heap()
        self.current_size = 0

    def get(self, key: str) -> Any:
        if self.heap.contains(key):
            return self.heap.get_item_by_key(key).value
        return self.kv_client.get(key)
