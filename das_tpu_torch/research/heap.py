"""Keyed min-heap ordered by item size.

Role of reference das/research/heap.py:12-117: the eviction
structure under the research layer's write-back cache — a binary
min-heap over (size, key, value) items with an auxiliary key→position
map so membership tests, keyed lookup, and in-place priority updates
(`fix_down` after a size change) are O(1)/O(log n).

Own implementation (array heap with position tracking); only the
surface the cache consumes is carried: push/pop, contains,
get_item_by_key, get_idx_by_key, indexed assignment + fix_down,
iteration, len.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List


@dataclass(order=True)
class PrioritizedItem:
    size: int
    key: str = field(compare=False)
    value: Any = field(compare=False)


class Heap:
    def __init__(self):
        self._v: List[PrioritizedItem] = []
        self._pos: Dict[str, int] = {}

    # -- sequence surface --------------------------------------------------

    def __len__(self) -> int:
        return len(self._v)

    def __bool__(self) -> bool:
        return bool(self._v)

    def __iter__(self) -> Iterator[PrioritizedItem]:
        return iter(self._v)

    def __getitem__(self, i: int) -> PrioritizedItem:
        return self._v[i]

    def __setitem__(self, i: int, item: PrioritizedItem) -> None:
        self._v[i] = item
        self._pos[item.key] = i

    # -- keyed access ------------------------------------------------------

    def contains(self, key: str) -> bool:
        return key in self._pos

    def get_item_by_key(self, key: str) -> PrioritizedItem:
        return self._v[self._pos[key]]

    def get_idx_by_key(self, key: str) -> int:
        return self._pos[key]

    # -- heap ops ----------------------------------------------------------

    def _swap(self, i: int, j: int) -> None:
        self[i], self[j] = self._v[j], self._v[i]

    def _up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) >> 1
            if self._v[i] < self._v[parent]:
                self._swap(i, parent)
                i = parent
            else:
                break

    def _down(self, i: int) -> None:
        n = len(self._v)
        while True:
            left, right = 2 * i + 1, 2 * i + 2
            smallest = i
            if left < n and self._v[left] < self._v[smallest]:
                smallest = left
            if right < n and self._v[right] < self._v[smallest]:
                smallest = right
            if smallest == i:
                return
            self._swap(i, smallest)
            i = smallest

    def heap_push(self, item: PrioritizedItem) -> None:
        self._v.append(item)
        self._pos[item.key] = len(self._v) - 1
        self._up(len(self._v) - 1)

    def heap_pop(self) -> PrioritizedItem:
        """Pop the smallest item, maintaining the invariant."""
        assert self._v
        top = self._v[0]
        last = self._v.pop()
        del self._pos[top.key]
        if self._v:
            self[0] = last
            self._down(0)
        return top

    def fix_down(self, item: PrioritizedItem) -> None:
        """Restore the invariant after `item` (already in the heap) had
        its size changed upward or was replaced in place."""
        i = self._pos.get(item.key)
        if i is None:
            return
        self._down(i)
        self._up(i)

    def remove_by_key(self, key: str) -> PrioritizedItem:
        """Remove and return the item stored under `key` (swap-with-last
        then repair) — the cache's update path detaches an old entry
        before re-inserting at its new size."""
        i = self._pos.pop(key)
        item = self._v[i]
        last = self._v.pop()
        if i < len(self._v):
            self[i] = last
            self._down(i)
            self._up(i)
        return item
