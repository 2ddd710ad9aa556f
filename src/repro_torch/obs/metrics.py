"""Bounded evidence for the serving plane.

Counterpart of ``repro/obs/metrics.py``, of which only :class:`RingLog`
is ported: the bounded log that the event-loop group's dispatch log and
the chaos harness's ``fired`` and ``emissions`` traces are kept in. The
metrics registry and its pull-based adapters (``publish_*``,
``collect``) are ROADMAP.md Queue 1 item 6.5.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable


class RingLog:
    """Bounded append-mostly log: the newest ``capacity`` entries with a
    ``dropped`` eviction count. List-like where the call sites need it —
    ``append``/``extend``/``len``/``iter``/``bool``/indexing/slicing and
    ``==`` against any sequence (the fairness tests compare dispatch
    logs to plain lists)."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"RingLog capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._q: deque = deque(maxlen=self.capacity)
        self.dropped = 0

    def append(self, item) -> None:
        if len(self._q) == self.capacity:
            self.dropped += 1
        self._q.append(item)

    def extend(self, items: Iterable) -> None:
        for it in items:
            self.append(it)

    def clear(self) -> None:
        self._q.clear()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._q)[i]
        return self._q[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, RingLog):
            return list(self._q) == list(other._q)
        if isinstance(other, (list, tuple)):
            return list(self._q) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"RingLog({list(self._q)!r}, capacity={self.capacity}, "
                f"dropped={self.dropped})")
