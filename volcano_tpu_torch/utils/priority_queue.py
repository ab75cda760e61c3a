"""Heap-backed priority queue over a less-function
(pkg/scheduler/util/priority_queue.go:26-94)."""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, List, Tuple


class _Item:
    __slots__ = ("value", "less", "seq")

    def __init__(self, value, less, seq):
        self.value = value
        self.less = less
        self.seq = seq

    def __lt__(self, other: "_Item") -> bool:
        if self.less(self.value, other.value):
            return True
        if self.less(other.value, self.value):
            return False
        return self.seq < other.seq  # stable


class PriorityQueue:
    """Pops the least element per ``less_fn`` (ties broken by insert order)."""

    def __init__(self, less_fn: Callable[[Any, Any], bool]):
        self._less = less_fn
        self._heap: List[_Item] = []
        self._seq = itertools.count()

    def push(self, value) -> None:
        heapq.heappush(self._heap, _Item(value, self._less, next(self._seq)))

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap).value

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)
