"""EventLoopGroup — the netty worker-group analogue (paper §IV).

Counterpart of ``repro/serving/event_loop.py`` (single-tenant form):

* :class:`Poller` — completion polling: ``busy`` spins on readiness,
  ``park`` blocks (the epoll fallback), ``adaptive`` spins for a bounded
  budget then parks — with counters of which path was taken. A CUDA
  completion is a ``torch.cuda.Event`` recorded after the step:
  spinning is ``event.query()``, parking ``event.synchronize()``. CPU
  tensors are always ready.
* :class:`EventLoop` — one loop: its index, the contiguous run of the
  channel pool it OWNS, its poller, and a run queue drained by a
  ``runner``.
* :class:`EventLoopGroup` — N loops; items are assigned round-robin and
  ``run()`` drains every loop, one OS thread per loop under
  ``threads=True``.
* :func:`channel_affinity` — disjoint contiguous runs of the channel
  pool, balanced to within one (``core.selector.ready_groups``).

Tenants, the chaos seams, restarts and the telemetry plane come in later
slices (ROADMAP.md).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.selector import ready_groups

POLLS = ("busy", "park", "adaptive")


def channel_affinity(n_channels: int, n_loops: int) -> tuple:
    """Each event loop's owned channels: ``n_loops`` disjoint contiguous
    runs covering ``0..n_channels-1``. Raises when a loop would own
    nothing."""
    if n_loops > n_channels:
        raise ValueError(
            f"{n_loops} event loops over {n_channels} channels: every "
            "loop must own at least one channel (disjoint ownership); "
            "raise comm.channels or lower event_loops")
    return ready_groups(n_channels, n_loops)


@dataclass
class PollStats:
    """``spins`` = readiness probes that came back not-ready, ``parks`` =
    blocking waits entered, ``waits`` = completed wait calls."""
    spins: int = 0
    parks: int = 0
    waits: int = 0

    def merge(self, other: "PollStats") -> "PollStats":
        return PollStats(self.spins + other.spins, self.parks + other.parks,
                         self.waits + other.waits)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class Poller:
    """Completion polling for one event loop (hadroNIO §IV-B: busy-poll
    the worker vs. park in epoll; ``adaptive`` is the bounded spin)."""

    def __init__(self, poll: str = "busy", spin_s: float = 50e-6):
        if poll not in POLLS:
            raise ValueError(f"unknown poll {poll!r}: expected one of {POLLS}")
        self.poll = poll
        self.spin_s = spin_s
        self.stats = PollStats()

    @staticmethod
    def _handles(tree: Any) -> list:
        """Completion handles of ``tree``: one event recorded on the
        current stream of each CUDA device its tensors live on, plus any
        leaf that is itself a handle (has ``query``/``synchronize``).
        CPU tensors contribute nothing — they are ready."""
        handles, devices = [], []
        for leaf in _leaves(tree):
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda and leaf.device not in devices:
                    devices.append(leaf.device)
            elif hasattr(leaf, "query") and hasattr(leaf, "synchronize"):
                handles.append(leaf)
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            handles.append(ev)
        return handles

    def _park(self, handles: list) -> None:
        self.stats.parks += 1
        for h in handles:
            h.synchronize()

    def wait(self, tree: Any) -> Any:
        """Wait for every tensor in ``tree`` per the strategy; returns
        ``tree`` so call sites can chain."""
        handles = self._handles(tree)
        self.stats.waits += 1
        if self.poll == "park" or (self.poll == "adaptive"
                                   and self.spin_s <= 0):
            # a zero spin budget IS park: one park, zero probes
            self._park(handles)
            return tree
        deadline = (time.perf_counter() + self.spin_s
                    if self.poll == "adaptive" else None)
        while not all(h.query() for h in handles):
            self.stats.spins += 1
            if deadline is not None and time.perf_counter() >= deadline:
                self._park(handles)     # adaptive: bounded spin, then park
                break
        return tree


class EventLoop:
    """One event loop: owned channels, a poller, and a run queue drained
    by ``runner(loop, items) -> list``."""

    def __init__(self, index: int, *, channels: Sequence[int] = (),
                 poll: str = "busy", spin_s: float = 50e-6,
                 runner: Optional[Callable] = None):
        self.index = index
        self.channels = tuple(channels)   # owned run of the global pool
        self.poller = Poller(poll, spin_s)
        self.runner = runner
        self.engine = None
        self.queue: deque = deque()
        self.results: list = []
        self.error: Optional[BaseException] = None

    def submit(self, item: Any) -> None:
        self.queue.append(item)

    def drain(self) -> list:
        """Run everything queued through the runner (items submitted
        while draining are picked up too). A runner failure is recorded
        in ``error`` and re-raised."""
        if self.runner is None:
            raise RuntimeError(f"event loop {self.index} has no runner")
        out: list = []
        self.error = None
        try:
            while self.queue:
                items = list(self.queue)
                self.queue.clear()
                out.extend(self.runner(self, items))
        except BaseException as e:
            self.error = e
            raise
        finally:
            self.results = out
        return out


class EventLoopGroup:
    """N event loops over one disjoint channel partition. ``submit``
    assigns items round-robin (paper §IV-C); ``run`` drains every loop —
    one OS thread per loop under ``threads=True``, in-line otherwise."""

    def __init__(self, loops: Sequence[EventLoop]):
        if not loops:
            raise ValueError("an EventLoopGroup needs at least one loop")
        owned = [c for l in loops for c in l.channels]
        if len(owned) != len(set(owned)):
            raise ValueError("channel ownership must be disjoint: "
                             f"{[l.channels for l in loops]}")
        self.loops = list(loops)
        self._rr = 0

    @property
    def n_loops(self) -> int:
        return len(self.loops)

    def submit(self, items: Any) -> None:
        """Round-robin item -> loop assignment; one item or a sequence."""
        if not isinstance(items, (list, tuple)):
            items = [items]
        for it in items:
            self.loops[self._rr % self.n_loops].submit(it)
            self._rr += 1

    def run(self, *, threads: bool = True) -> list:
        """Drain every loop; returns the concatenated results in loop
        order. A failure in any loop propagates after every thread has
        joined, so a partial result set never looks like success."""
        if threads and self.n_loops > 1:
            def guarded(loop):
                try:
                    loop.drain()
                except BaseException:
                    pass              # kept in loop.error; raised below
            ts = [threading.Thread(target=guarded, args=(l,),
                                   name=f"event-loop-{l.index}")
                  for l in self.loops]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            failed = [l for l in self.loops if l.error is not None]
            if failed:
                raise failed[0].error
        else:
            for l in self.loops:
                l.drain()
        return [r for l in self.loops for r in l.results]

    def poll_stats(self) -> PollStats:
        st = PollStats()
        for l in self.loops:
            st = st.merge(l.poller.stats)
        return st
