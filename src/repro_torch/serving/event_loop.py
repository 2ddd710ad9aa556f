"""EventLoopGroup — the netty worker-group analogue (paper §IV).

Counterpart of ``repro/serving/event_loop.py``:

* :class:`Poller` — completion polling: ``busy`` spins on readiness,
  ``park`` blocks (the epoll fallback), ``adaptive`` spins for a bounded
  budget then parks — with counters of which path was taken. A CUDA
  completion is a ``torch.cuda.Event`` recorded after the step:
  spinning is ``event.query()``, parking ``event.synchronize()``. CPU
  tensors are always ready.
* :class:`EventLoop` — one loop: its index, the contiguous run of the
  channel pool it OWNS, its poller, and a run queue drained by a
  ``runner``.
* :class:`EventLoopGroup` — N loops; items are assigned round-robin, or
  per tenant in weighted-fair stride order, and ``run()`` drains every
  loop, one OS thread per loop under ``threads=True``.
* :func:`channel_affinity` — disjoint contiguous runs of the channel
  pool, balanced to within one (``core.selector.ready_groups``).

The chaos seams (``serving/chaos.py``) are the reference's:
``Poller.fault`` (consulted once at the top of every wait),
``EventLoop.drain_hook`` (called with ``(loop, items)`` before the
runner), heartbeats, ``restart()`` with lifetime poll stats, and
structured :class:`LoopFailure` records on the group. Each drained
batch runs inside a ``drain`` span when tracing is on
(``obs/trace.py``). The topology form of :func:`channel_affinity`
(leader lanes, pods) comes with the pod fabric (ROADMAP.md Queue 1 item
8).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.selector import ready_groups
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import RingLog

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
    blocking waits entered, ``waits`` = completed wait calls, ``stalls``
    = parks FORCED by the fault seam (the chaos harness's over-parking
    loop), ``delays`` = waits the fault seam slowed down without forcing
    a park (a slow channel's completion arriving late). A fault-free run
    keeps stalls and delays at 0."""
    spins: int = 0
    parks: int = 0
    waits: int = 0
    stalls: int = 0
    delays: int = 0

    def merge(self, other: "PollStats") -> "PollStats":
        return PollStats(self.spins + other.spins, self.parks + other.parks,
                         self.waits + other.waits,
                         self.stalls + other.stalls,
                         self.delays + other.delays)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class Poller:
    """Completion polling for one event loop (hadroNIO §IV-B: busy-poll
    the worker vs. park in epoll; ``adaptive`` is the bounded spin).

    ``fault`` is the chaos seam (``serving/chaos.py``): when set, it is
    called once at the top of every :meth:`wait` with the poller itself
    and may sleep (a slow channel's completion arriving late) or return
    a verdict — ``"stall"`` forces an immediate park (counted in
    ``stats.stalls``), ``"delay"`` reports that the hook slowed this
    wait and proceeds normally (counted in ``stats.delays``). ``None``
    (the default) is a no-op."""

    def __init__(self, poll: str = "busy", spin_s: float = 50e-6):
        if poll not in POLLS:
            raise ValueError(f"unknown poll {poll!r}: expected one of {POLLS}")
        self.poll = poll
        self.spin_s = spin_s
        self.stats = PollStats()
        self.fault: Optional[Callable[["Poller"], Optional[str]]] = None

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
        if self.fault is not None:
            verdict = self.fault(self)
            if verdict == "stall":
                self.stats.stalls += 1  # forced over-park (chaos seam)
                self._park(handles)
                return tree
            if verdict == "delay":
                self.stats.delays += 1  # slowed wait; proceed normally
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


@dataclass(frozen=True)
class LoopFailure:
    """Structured record of one failed drain: WHICH loop died, WHAT
    killed it (the ``repr`` of the exception, so records stay picklable
    and comparable; the live exception stays on ``loop.error``), and
    HOW MANY items were in flight (the failed batch plus anything still
    queued)."""
    loop_index: int
    error: str
    pending: int


class EventLoop:
    """One event loop: owned channels, a poller, and a run queue drained
    by ``runner(loop, items) -> list``. ``heartbeats`` counts drained
    batches, ever; ``restarts`` the :meth:`restart` calls;
    ``lifetime_stats`` the folded stats of retired pollers.
    ``drain_hook`` (the chaos seam) is called with ``(loop, items)`` per
    drained batch, before the runner."""

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
        self.failed_items: list = []      # in-flight batch of a failed drain
        self.heartbeats = 0
        self.restarts = 0
        self.lifetime_stats = PollStats()
        self.drain_hook: Optional[Callable] = None

    def submit(self, item: Any) -> None:
        self.queue.append(item)

    def drain(self) -> list:
        """Run everything queued through the runner (items submitted
        while draining are picked up too). A runner failure is recorded
        in ``error`` and re-raised; the in-flight batch is kept in
        ``failed_items`` for whoever re-admits it after a restart."""
        if self.runner is None:
            raise RuntimeError(f"event loop {self.index} has no runner")
        out: list = []
        self.error = None
        self.failed_items = []
        items: list = []
        try:
            while self.queue:
                items = list(self.queue)
                self.queue.clear()
                if self.drain_hook is not None:
                    self.drain_hook(self, items)
                if obs_trace.enabled():
                    with obs_trace.span("drain", f"loop{self.index}",
                                        loop=self.index, items=len(items)):
                        out.extend(self.runner(self, items))
                else:
                    out.extend(self.runner(self, items))
                self.heartbeats += 1    # one beat per drained batch
        except BaseException as e:
            self.error = e
            self.failed_items = items
            raise
        finally:
            self.results = out
        return out

    def restart(self) -> Poller:
        """Quarantine-and-restart: fold the retiring poller's counters
        into ``lifetime_stats``, replace it with a FRESH one (same
        strategy and spin budget, no fault seam, zeroed counters), forget
        the failure state and re-point an attached engine at the new
        poller. The caller re-admits ``failed_items`` and the queue."""
        self.lifetime_stats = self.lifetime_stats.merge(self.poller.stats)
        self.poller = Poller(self.poller.poll, self.poller.spin_s)
        self.error = None
        self.failed_items = []
        self.restarts += 1
        if self.engine is not None:
            self.engine.poller = self.poller
        return self.poller

    def poll_stats(self) -> PollStats:
        """Lifetime poll counters: every retired poller's stats merged
        with the live poller's."""
        return self.lifetime_stats.merge(self.poller.stats)


class EventLoopGroup:
    """N event loops over one disjoint channel partition. ``submit``
    assigns items round-robin (paper §IV-C); ``run`` drains every loop —
    one OS thread per loop under ``threads=True``, in-line otherwise.

    Multi-tenant form: ``tenants`` is a sequence of ``(name, weight,
    loop_indices)`` bindings that partition the loops (contiguous ranges
    built by ``engine.make_engine_group`` from ``ServeConfig.tenants``).
    ``submit`` then routes each item to ITS tenant's loops (round-robin
    within the tenant) and orders a mixed batch with a deterministic
    weighted-fair stride scheduler: the next item belongs to the tenant
    minimising ``(dispatched[t] + 1) / weight[t]``, ties broken in
    declaration order — weights 2:1 give A A B A A B. The cumulative
    per-tenant counts are ``fairness_counters`` and the per-item routing
    trace ``dispatch_log`` (a :class:`RingLog`). Untagged items
    (``tenant`` empty or absent) ride the first tenant; an unknown
    tenant name raises.

    ``loop_failures`` counts loops whose drain raised, across runs;
    ``failures`` holds their :class:`LoopFailure` records in the order
    they were observed."""

    def __init__(self, loops: Sequence[EventLoop],
                 tenants: Optional[Sequence] = None, *,
                 dispatch_log_capacity: int = 65536):
        if not loops:
            raise ValueError("an EventLoopGroup needs at least one loop")
        owned = [c for l in loops for c in l.channels]
        if len(owned) != len(set(owned)):
            raise ValueError("channel ownership must be disjoint: "
                             f"{[l.channels for l in loops]}")
        self.loops = list(loops)
        self._rr = 0
        self.tenants = tuple(tenants) if tenants else ()
        self._torder = [t[0] for t in self.tenants]
        self._tweight = {n: w for n, w, _ in self.tenants}
        self._tloops = {n: tuple(ix) for n, _, ix in self.tenants}
        self._trr = {n: 0 for n in self._torder}
        self.fairness_counters = {n: 0 for n in self._torder}
        self.dispatch_log = RingLog(dispatch_log_capacity)
        if self.tenants:
            allix = sorted(i for _, _, ix in self.tenants for i in ix)
            if allix != list(range(self.n_loops)):
                raise ValueError(
                    f"tenant loop ranges must partition the group's "
                    f"{self.n_loops} loops: {self._tloops}")
        self.loop_failures = 0
        self.failures: list = []

    @property
    def n_loops(self) -> int:
        return len(self.loops)

    def submit(self, items: Any) -> None:
        """Round-robin item -> loop assignment; one item or a sequence.
        With tenants, routes per tenant in weighted-fair stride order
        (the class docstring)."""
        if not isinstance(items, (list, tuple)):
            items = [items]
        if not self.tenants:
            for it in items:
                self.loops[self._rr % self.n_loops].submit(it)
                self._rr += 1
            return
        pending = {n: deque() for n in self._torder}
        for it in items:
            name = getattr(it, "tenant", "") or self._torder[0]
            if name not in pending:
                raise ValueError(
                    f"unknown tenant {name!r}: this group serves "
                    f"{self._torder} (Request.tenant must name one, or be "
                    "empty to ride the first tenant)")
            pending[name].append(it)
        remaining = sum(len(q) for q in pending.values())
        while remaining:
            name = min((n for n in self._torder if pending[n]),
                       key=lambda n: ((self.fairness_counters[n] + 1)
                                      / self._tweight[n]))
            it = pending[name].popleft()
            ix = self._tloops[name]
            self.loops[ix[self._trr[name] % len(ix)]].submit(it)
            self._trr[name] += 1
            self.fairness_counters[name] += 1
            self.dispatch_log.append(name)
            remaining -= 1

    def _record_failure(self, loop: EventLoop) -> None:
        self.loop_failures += 1
        self.failures.append(LoopFailure(
            loop.index, repr(loop.error),
            len(loop.failed_items) + len(loop.queue)))

    def run(self, *, threads: bool = True,
            raise_on_failure: bool = True) -> list:
        """Drain every loop; returns the concatenated results in loop
        order. A failure in ANY loop is recorded as a
        :class:`LoopFailure` in ``failures`` and, by default, raised
        after every thread has joined, so a partial result set never
        looks like success. ``raise_on_failure=False`` (the supervisor's
        entry point) returns the survivors' results instead: the failed
        loop's ``Exception`` stays on ``loop.error`` and in its record,
        its batch in ``failed_items``. A ``BaseException`` that is not an
        ``Exception`` (an interrupt, an exit) is raised either way."""
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
            for l in failed:
                self._record_failure(l)
            fatal = [l for l in failed if raise_on_failure
                     or not isinstance(l.error, Exception)]
            if fatal:
                raise fatal[0].error
        else:
            for l in self.loops:
                try:
                    l.drain()
                except BaseException as e:
                    self._record_failure(l)
                    if raise_on_failure or not isinstance(e, Exception):
                        raise
        return [r for l in self.loops for r in l.results]

    def poll_stats(self) -> PollStats:
        """Lifetime poll counters of every loop (they survive restarts)."""
        st = PollStats()
        for l in self.loops:
            st = st.merge(l.poll_stats())
        return st
