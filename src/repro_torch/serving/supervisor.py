"""Self-healing serving supervisor: detect -> decide -> heal.

Counterpart of ``repro/serving/supervisor.py``. The paper's netty /
hadroNIO design keeps throughput stable by binding connections to event
loops and letting the worker pool absorb load (§IV); Ibdxnet
(arXiv:1812.01963) shows the same architecture needs demand-driven
worker management and failure isolation to survive real concurrency.
The chaos harness (``serving/chaos.py``) *injects* those failures; this
module is the layer that *reacts*. A :class:`Supervisor` wraps the
``EventLoopGroup`` + ``DecodeEngine`` fleet (``make_engine_group``) and
runs the serving plane in ROUNDS: dispatch a quantum from the bounded
admission queue, drain the fleet, then close the loop.

**Detect**: a health model fed only from DETERMINISTIC seams:

* ``PollStats`` counters per loop (``stalls`` = forced over-parks,
  ``delays`` = fault-slowed waits) diffed per round and folded into an
  EWMA per signal;
* structured ``EventLoopGroup.failures`` records (loop index, exception
  repr, pending count) from non-raising drains;
* ``pipeline.current_stats().drops`` deltas: dropped flushes (the active
  :func:`pipeline.stats_scope`, module-global by default), counted per
  call in the port where the reference counts them per traced shape;
* a heartbeat deadline per loop (``EventLoop.heartbeats`` must advance
  whenever the loop had work) measured in ROUNDS, not seconds;
* run-queue depth (admission backlog per loop) for autoscaling;
* per-channel emission counts via ``channels.set_collective_hook``
  (composed with any hook already installed), exposed as
  ``emission_counts``.

**Heal**: every decision appends a structured :class:`HealAction`:

* *quarantine-and-restart*: a stalled or failed loop gets a FRESH poller
  (``EventLoop.restart``, which clears a wedged fault seam), its queued
  requests migrate to survivors, and a persistently unhealthy loop
  shrinks the fleet through the elastic reshard;
* *retry with backoff*: a failed drain's in-flight batch
  (``failed_items``) is re-admitted under a capped-exponential
  :class:`RetryBudget` with seeded jitter and a per-incident deadline;
  exhaustion surfaces a structured ``retry_exhausted`` :class:`Outcome`
  (its reason the ``repr`` of the last exception) instead of a hang. A
  retry catches ``Exception`` only: an interrupt or exit propagates;
* *elastic resize*: grow or shrink ``event_loops`` between flush
  boundaries, from queue depth with hysteresis and cooldown (autoscale)
  or on external demand (:meth:`Supervisor.request_resize`), through
  ``launch/elastic.reshard_event_loops`` + the minimal-migration
  ``reshard_affinity``, rebuilding the fleet with the EXPLICIT resharded
  affinity;
* *admission control*: a bounded admission queue with backpressure
  (over capacity the LOWEST-priority request is shed with an explicit
  ``rejected`` outcome), and in-wave bursts (the chaos storm seam) are
  gated per engine (``DecodeEngine.admission_gate``). Admission itself
  is batched: the engine prefills every freed slot in one call.

**Determinism contract**: every healing decision keys off counters
(stalls, delays, drops, failures, queue depths, rounds), never wall
clock; backoff jitter draws from one ``numpy`` Generator seeded at
construction (not a torch generator: the draws, and so the canonical
trace, equal the reference's for the same seed). Same seed + same
ChaosPlan => same :meth:`Supervisor.healing_trace` (which EXCLUDES the
wall-clock ``t_detect``/``t_heal`` stamps: those only feed MTTR, through
``slo.mttr``).

The fleet lives on ``device`` over ``ring`` (the reference's ``mesh``),
as ``make_engine_group``'s does. Each heal action is also recorded as a
``heal`` span (``obs/trace.py``) from its detect and heal stamps.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.compat import DeviceLike
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import channels as channels_mod
from repro_torch.core.backends import pipeline
from repro_torch.core.channels import Ring
from repro_torch.launch.elastic import reshard_affinity, reshard_event_loops
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import slo
from repro_torch.serving.engine import Request, make_engine_group
from repro_torch.serving.event_loop import EventLoop, PollStats


@dataclass(frozen=True)
class RetryBudget:
    """Capped exponential backoff for drain retries: attempt ``a`` waits
    ``min(cap_s, base_s * 2**a)`` scaled by ``1 ± jitter`` (drawn from
    the supervisor's SEEDED rng — deterministic backoff trace), at most
    ``limit`` retry attempts, bounded by a per-incident wall-clock
    ``deadline_s``. Exhaustion is surfaced as a structured
    ``retry_exhausted`` :class:`Outcome`, never a hang."""
    limit: int = 3
    base_s: float = 1e-3
    cap_s: float = 20e-3
    jitter: float = 0.25
    deadline_s: float = 30.0

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        raw = min(self.cap_s, self.base_s * (2.0 ** attempt))
        if self.jitter > 0:
            raw *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return max(0.0, raw)


@dataclass(frozen=True)
class Outcome:
    """Terminal disposition of one request uid: ``served`` (tokens
    delivered), ``rejected`` (shed by admission control), or
    ``retry_exhausted`` (the retry budget ran dry re-draining it).
    ``attempts`` counts drain attempts (1 = served first try)."""
    uid: int
    status: str
    reason: str = ""
    attempts: int = 1


@dataclass(frozen=True)
class HealAction:
    """One supervisor decision. ``kind`` ∈ {quarantine, restart, retry,
    retry_exhausted, reflush, resize, shed, backpressure};
    ``target``/``detail`` are kind-specific but always deterministic;
    ``t_detect``/``t_heal`` are wall-clock stamps for MTTR only and are
    EXCLUDED from the canonical trace."""
    round: int
    kind: str
    target: int
    detail: tuple = ()
    t_detect: float = 0.0
    t_heal: float = 0.0

    @property
    def span_s(self) -> float:
        return max(0.0, self.t_heal - self.t_detect)


@dataclass(frozen=True)
class SupervisorConfig:
    """Knobs of the detect/decide/heal loop. Health: per-loop EWMAs of
    the per-round stall/delay deltas (``ewma_alpha``) against
    ``stall_limit``/``delay_limit``; a loop whose heartbeats don't
    advance for ``heartbeat_rounds`` rounds-with-work is declared dead;
    more than ``max_restarts`` quarantines shrinks the fleet. Autoscale:
    admission backlog per loop ≥ ``scale_up_depth`` votes to grow, ≤
    ``scale_down_depth`` votes to shrink (negative disables shrink —
    the default, so finite runs don't thrash on their natural
    drain-down); ``hysteresis`` consecutive votes act, then
    ``cooldown_rounds`` rounds of quiet. Admission: ``admission_capacity``
    bounds BOTH the client queue and the per-run in-wave burst budget;
    ``dispatch_quantum`` requests leave the queue per round (0 = all).
    ``max_rounds`` is the structured runaway bound — exceeding it raises
    instead of spinning forever."""
    ewma_alpha: float = 0.5
    stall_limit: float = 0.5
    delay_limit: float = 0.5
    heartbeat_rounds: int = 2
    max_restarts: int = 2
    scale_up_depth: float = 8.0
    scale_down_depth: float = -1.0
    hysteresis: int = 2
    cooldown_rounds: int = 1
    min_loops: int = 1
    max_loops: int = 0            # 0 = the channel pool size
    admission_capacity: int = 64
    dispatch_quantum: int = 0     # 0 = drain the whole queue per round
    max_rounds: int = 64
    retry: RetryBudget = RetryBudget()


class Supervisor:
    """The self-healing serving fleet. Construction is LAZY: the group
    is built on first :meth:`run` so callers can arm ``fleet_hook``
    first — it is invoked with every (re)built ``EventLoopGroup``, which
    is how the chaos harness re-arms its injections across supervisor
    rebuilds (a loop-level ``restart`` deliberately does NOT re-invoke
    it: a fresh poller genuinely clears a poller fault — that's the
    healing)."""

    def __init__(self, cfg: ModelConfig, params: Any, serve: ServeConfig,
                 *, device: DeviceLike = None, ring: Optional[Ring] = None,
                 config: Optional[SupervisorConfig] = None,
                 seed: int = 0, eos_id: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.device = device
        self.ring = ring
        self.config = config or SupervisorConfig()
        self.seed = seed
        self.eos_id = eos_id
        self._rng = np.random.default_rng(seed)   # backoff jitter only
        self.queue: deque = deque()               # bounded admission queue
        self.trace: List[HealAction] = []
        self.outcomes: Dict[int, Outcome] = {}
        self.emission_counts: Dict[int, int] = {}
        self.fleet_hook = None
        self.rounds = 0
        self._group = None
        self._affinity = None                     # explicit after a resize
        self._resize_request: Optional[int] = None
        self._served: set = set()
        self._attempts: Dict[int, int] = {}
        self._ewma: Dict[int, Dict[str, float]] = {}
        self._missed: Dict[int, int] = {}
        self._restarts: Dict[int, int] = {}
        self._restarted_this_round: set = set()
        self._votes = 0
        self._cooldown = 0
        self._wave_admissions = 0
        self._poll_accum = PollStats()

    # -- admission (bounded queue + backpressure) ----------------------

    def submit(self, reqs) -> None:
        """Enqueue client requests through the bounded admission queue.
        Over capacity, the LOWEST-priority request in (queue + newcomer)
        is shed with a ``rejected`` outcome — graceful degradation, not
        unbounded queuing."""
        if isinstance(reqs, Request):
            reqs = [reqs]
        for r in reqs:
            self._enqueue(r)

    def _enqueue(self, req: Request) -> None:
        c = self.config
        if len(self.queue) < c.admission_capacity:
            self.queue.append(req)
            return
        t0 = time.perf_counter()
        victim = min(self.queue,
                     key=lambda r: (getattr(r, "priority", 0), -r.uid))
        if getattr(req, "priority", 0) > getattr(victim, "priority", 0):
            self.queue.remove(victim)
            self.queue.append(req)
            out = victim
        else:
            out = req
        self.outcomes[out.uid] = Outcome(out.uid, "rejected",
                                         "admission_queue_full", 0)
        self._action("shed", out.uid, (getattr(out, "priority", 0),), t0)

    def _admission_gate(self, engine, step: int, extra: list) -> list:
        """In-wave admission control (``DecodeEngine.admission_gate``):
        a hook-injected burst — the chaos storm seam — passes through
        the same bounded budget, highest priority first; the overflow is
        shed with ``rejected`` outcomes."""
        if not extra:
            return extra
        c = self.config
        t0 = time.perf_counter()
        ranked = sorted(extra,
                        key=lambda r: (-getattr(r, "priority", 0), r.uid))
        admitted, shed = [], []
        for r in ranked:
            if self._wave_admissions < c.admission_capacity:
                self._wave_admissions += 1
                admitted.append(r)
            else:
                shed.append(r)
        self._action("backpressure", step,
                     (len(extra), len(admitted), len(shed)), t0)
        for r in shed:
            self.outcomes[r.uid] = Outcome(r.uid, "rejected",
                                           "admission_capacity", 0)
            self._action("shed", r.uid, (getattr(r, "priority", 0),), t0)
        return admitted

    # -- fleet construction --------------------------------------------

    def _build_group(self):
        self._group = make_engine_group(
            self.cfg, self.params, self.serve, device=self.device,
            ring=self.ring, eos_id=self.eos_id, seed=self.seed,
            affinity=self._affinity)
        if self.fleet_hook is not None:
            self.fleet_hook(self._group)
        for l in self._group.loops:
            l.engine.admission_gate = self._admission_gate
        return self._group

    @property
    def group(self):
        if self._group is None:
            self._build_group()
        return self._group

    def request_resize(self, new_loops: int) -> None:
        """External elasticity demand (cluster manager / chaos reshard
        scenario): applied at the next round boundary through the same
        resize path the autoscaler uses."""
        self._resize_request = int(new_loops)

    # -- the supervised serving loop -----------------------------------

    def run(self, *, threads: bool = False) -> list:
        """Serve everything admitted so far, healing as needed; returns
        Results sorted by uid. Inline drains (``threads=False``) give a
        fully deterministic healing trace; threaded drains keep the
        healing semantics but interleave wall-clock (and over a ring of
        more than one peer must not be used: every peer has to issue the
        loops' collectives in the same order)."""
        g = self.group
        results: list = []
        self._wave_admissions = 0
        prev_hook = channels_mod.get_collective_hook()

        def emission_hook(c, kind):
            self.emission_counts[c] = self.emission_counts.get(c, 0) + 1
            if prev_hook is not None:
                prev_hook(c, kind)

        channels_mod.set_collective_hook(emission_hook)
        try:
            while self.queue or any(l.queue or l.failed_items
                                    for l in self._group.loops):
                self.rounds += 1
                if self.rounds > self.config.max_rounds:
                    raise RuntimeError(
                        f"supervisor exceeded max_rounds="
                        f"{self.config.max_rounds} with "
                        f"{len(self.queue)} requests still queued — "
                        "healing is not converging")
                self._restarted_this_round = set()
                self._dispatch()
                snap = self._snapshot()
                out = self._group.run(threads=threads,
                                      raise_on_failure=False)
                self._collect(out, results)
                # heal phase: runs after EVERY round (including the last)
                self._heal_failures(snap, results)
                self._detect_reflush(snap)
                self._health_check(snap)
                self._apply_external_resize()
                self._autoscale()
        finally:
            channels_mod.set_collective_hook(prev_hook)
        for r in results:
            self.outcomes[r.uid] = Outcome(
                r.uid, "served", attempts=self._attempts.get(r.uid, 1))
        results.sort(key=lambda r: r.uid)
        return results

    def _dispatch(self) -> None:
        q = self.config.dispatch_quantum or len(self.queue)
        batch = [self.queue.popleft()
                 for _ in range(min(q, len(self.queue)))]
        if batch:
            self._group.submit(batch)

    def _snapshot(self) -> dict:
        g = self._group
        return {
            "stalls": {l.index: l.poller.stats.stalls for l in g.loops},
            "delays": {l.index: l.poller.stats.delays for l in g.loops},
            "beats": {l.index: l.heartbeats for l in g.loops},
            "dispatched": {l.index for l in g.loops if l.queue},
            "drops": pipeline.current_stats().drops,
            "failures": len(g.failures),
        }

    def _collect(self, out: list, results: list) -> None:
        for r in out:
            if r.uid in self._served:
                continue
            self._served.add(r.uid)
            results.append(r)

    # -- detect → heal -------------------------------------------------

    def _action(self, kind: str, target: int, detail: tuple,
                t_detect: float) -> HealAction:
        a = HealAction(self.rounds, kind, int(target), tuple(detail),
                       t_detect, time.perf_counter())
        self.trace.append(a)
        obs_trace.complete("heal", kind, a.t_detect, a.t_heal,
                           round=self.rounds, target=int(target))
        return a

    def _heal_failures(self, snap: dict, results: list) -> None:
        """Retry/backoff healing for loops whose drain raised: restart
        the loop, re-admit its in-flight batch under the RetryBudget."""
        fresh = self._group.failures[snap["failures"]:]
        for lf in fresh:
            loop = self._group.loops[lf.loop_index]
            t0 = time.perf_counter()
            items = list(loop.failed_items) + list(loop.queue)
            loop.queue.clear()
            self._restarts[loop.index] = \
                self._restarts.get(loop.index, 0) + 1
            self._action("quarantine", loop.index,
                         ("drain_failure", lf.error, len(items)), t0)
            loop.restart()
            self._restarted_this_round.add(loop.index)
            self._action("restart", loop.index, (), t0)
            self._reset_health(loop.index)
            if items:
                self._retry_items(loop, items, t0, results)

    def _retry_items(self, loop: EventLoop, items: list, t0: float,
                     results: list) -> None:
        budget = self.config.retry
        deadline = t0 + budget.deadline_s
        last: Optional[Exception] = None
        for attempt in range(budget.limit):
            back = budget.backoff_s(attempt, self._rng)
            if back > 0:
                time.sleep(back)
            for it in items:
                loop.submit(it)
            try:
                out = loop.drain()
            except Exception as e:      # recorded in the outcome below
                last = e
                items = list(loop.failed_items) + list(loop.queue)
                loop.queue.clear()
                loop.restart()
                if time.perf_counter() >= deadline:
                    break
                continue
            for r in out:
                self._attempts[r.uid] = attempt + 2
            self._collect(out, results)
            self._action("retry", loop.index,
                         (attempt + 1, round(back, 9), len(items)), t0)
            return
        # budget exhausted: structured surfacing, never a hang
        uids = tuple(sorted(getattr(it, "uid", -1) for it in items))
        for it in items:
            uid = getattr(it, "uid", None)
            if uid is not None:
                self.outcomes[uid] = Outcome(
                    uid, "retry_exhausted", repr(last), budget.limit + 1)
        self._action("retry_exhausted", loop.index,
                     (budget.limit, uids, repr(last)), t0)

    def _detect_reflush(self, snap: dict) -> None:
        drops = pipeline.current_stats().drops - snap["drops"]
        if drops > 0:
            t0 = time.perf_counter()
            # the staged-emission completeness contract already
            # re-flushed every dropped channel at the finish_emission
            # barrier; the supervisor's job is to DETECT it happened and
            # verify the round's outputs were complete (they were — the
            # drain returned), recorded as a healing observation
            self._action("reflush", drops, ("finish_emission_barrier",),
                         t0)

    def _reset_health(self, index: int) -> None:
        self._ewma.pop(index, None)
        self._missed.pop(index, None)

    def _health_check(self, snap: dict) -> None:
        c = self.config
        for l in list(self._group.loops):
            i = l.index
            if i in self._restarted_this_round:
                continue
            d_stall = max(0, l.poller.stats.stalls
                          - snap["stalls"].get(i, 0))
            d_delay = max(0, l.poller.stats.delays
                          - snap["delays"].get(i, 0))
            ew = self._ewma.setdefault(i, {"stalls": 0.0, "delays": 0.0})
            ew["stalls"] = c.ewma_alpha * d_stall \
                + (1 - c.ewma_alpha) * ew["stalls"]
            ew["delays"] = c.ewma_alpha * d_delay \
                + (1 - c.ewma_alpha) * ew["delays"]
            if i in snap["dispatched"] \
                    and l.heartbeats == snap["beats"].get(i, 0) \
                    and l.error is None:
                self._missed[i] = self._missed.get(i, 0) + 1
            else:
                self._missed[i] = 0
            reason = None
            # >= so a single fault event per round (EWMA alpha*1 ==
            # the default limit) is already detectable
            if ew["stalls"] >= c.stall_limit:
                reason = "stall_ewma"
            elif ew["delays"] >= c.delay_limit:
                reason = "delay_ewma"
            elif self._missed.get(i, 0) >= c.heartbeat_rounds:
                reason = "heartbeat"
            if reason is not None:
                self._quarantine(l, reason,
                                 round(ew["stalls"], 9),
                                 round(ew["delays"], 9))

    def _quarantine(self, loop: EventLoop, reason: str,
                    ew_stalls: float, ew_delays: float) -> None:
        """Health-driven quarantine-and-restart: migrate the loop's
        queued requests to survivors, give it a fresh poller; a loop
        needing this more than ``max_restarts`` times shrinks the fleet
        (the elastic eviction — channels migrate via the minimal
        reshard)."""
        t0 = time.perf_counter()
        items = list(loop.queue)
        loop.queue.clear()
        self._restarts[loop.index] = self._restarts.get(loop.index, 0) + 1
        self._action("quarantine", loop.index,
                     (reason, ew_stalls, ew_delays, len(items)), t0)
        loop.restart()
        self._restarted_this_round.add(loop.index)
        self._action("restart", loop.index, (), t0)
        self._reset_health(loop.index)
        survivors = [x for x in self._group.loops if x is not loop]
        for j, it in enumerate(items):
            (survivors[j % len(survivors)] if survivors else loop).submit(it)
        if self._restarts[loop.index] > self.config.max_restarts \
                and self._group.n_loops > max(1, self.config.min_loops):
            self._apply_resize(self._group.n_loops - 1, "unhealthy_loop")

    # -- elasticity ----------------------------------------------------

    def _max_loops(self) -> int:
        cap = self.config.max_loops or self.serve.comm.channels
        return min(cap, self.serve.comm.channels)

    def _apply_external_resize(self) -> None:
        if self._resize_request is None:
            return
        n, self._resize_request = self._resize_request, None
        self._apply_resize(n, "requested")

    def _autoscale(self) -> None:
        c = self.config
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        n = self._group.n_loops
        depth = len(self.queue) / n
        if self.queue and depth >= c.scale_up_depth \
                and n < self._max_loops():
            self._votes = self._votes + 1 if self._votes > 0 else 1
        elif c.scale_down_depth >= 0 and depth <= c.scale_down_depth \
                and n > c.min_loops:
            self._votes = self._votes - 1 if self._votes < 0 else -1
        else:
            self._votes = 0
            return
        if self._votes >= c.hysteresis:
            self._votes = 0
            self._cooldown = c.cooldown_rounds
            self._apply_resize(n + 1, "queue_depth")
        elif self._votes <= -c.hysteresis:
            self._votes = 0
            self._cooldown = c.cooldown_rounds
            self._apply_resize(n - 1, "drain_idle")

    def _apply_resize(self, new_loops: int, reason: str) -> None:
        """Grow/shrink the fleet at a round (flush) boundary: re-derive
        the ServeConfig, reshard channel affinity with MINIMAL migration,
        rebuild the group with the explicit resharded partition, carry
        undrained items over. Served tokens are invariant to the resize
        (affinity changes emission structure, never logits)."""
        c = self.config
        new_loops = max(c.min_loops, min(int(new_loops), self._max_loops()))
        g = self._group
        if g is None or new_loops == g.n_loops:
            return
        t0 = time.perf_counter()
        old_n = g.n_loops
        old_aff = tuple(l.channels for l in g.loops)
        carry = [it for l in g.loops for it in list(l.queue)]
        for l in g.loops:
            l.queue.clear()
        self._poll_accum = self._poll_accum.merge(g.poll_stats())
        self.serve = reshard_event_loops(self.serve, new_loops)
        # the flat fabric only: the pod-aware form waits with the pod
        # fabric (ROADMAP.md Queue 1 item 8)
        new_aff, moved = reshard_affinity(
            self.serve.comm.channels, old_aff, new_loops)
        self._affinity = new_aff
        self._build_group()
        if carry:
            self._group.submit(carry)
        self._ewma.clear()
        self._missed.clear()
        self._action("resize", new_loops, (old_n, moved, reason), t0)

    # -- reporting -----------------------------------------------------

    def healing_trace(self) -> tuple:
        """The canonical, seed-deterministic trace: every action minus
        its wall-clock stamps. Same seed + same ChaosPlan ⇒ equal
        traces across runs — the replayability contract tests assert."""
        return tuple((a.round, a.kind, a.target, a.detail)
                     for a in self.trace)

    def mttr_spans(self) -> tuple:
        return tuple(a.span_s for a in self.trace)

    def mttr_s(self) -> Optional[float]:
        return slo.mttr(self.mttr_spans())

    def poll_stats(self) -> PollStats:
        st = self._poll_accum
        if self._group is not None:
            st = st.merge(self._group.poll_stats())
        return st
