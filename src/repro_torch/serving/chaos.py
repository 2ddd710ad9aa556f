"""Deterministic chaos harness for the serving plane.

Counterpart of ``repro/serving/chaos.py``, its supervised runner
(:func:`run_supervised`, under ``serving/supervisor.py``) included.

Ibdxnet (arXiv:1812.01963) catalogues how concurrent event-loop
transports fail: stalled completion polling, starved send threads,
backpressured buffers. The JIB benchmark paper (arXiv:1910.02245) asks
that acceleration layers be evaluated under identical, reproducible
conditions. Every fault is drawn from one seeded
``numpy.random.Generator`` into a static :class:`ChaosPlan`, so a seed
always gives the same injection trace, and every scenario checks
RECOVERY (served tokens equal to the fault-free run's, ``serving/slo``).

Scenarios and the seams they hook:

* ``slow_channel`` — seeded delays on the completion waits of the loop
  owning the target channel (``Poller.fault``).
* ``stalled_loop`` — a poller forced to over-park (``Poller.fault``
  returning ``"stall"``, counted in ``PollStats.stalls``).
* ``dropped_flush`` — a faulty ``flush_ready`` in the staged emission
  (``pipeline.set_flush_fault``): ready channels dropped (recovered by
  the ``finish_emission`` barrier) or duplicated (a shadow flush).
* ``admission_storm`` — seeded bursts of extra requests at the engine's
  flush boundary (``DecodeEngine.admission_hook``).
* ``reshard_mid_request`` — the fleet resized between waves
  (``launch/elastic.reshard_event_loops`` / ``reshard_affinity``): queued
  requests migrate to a group of another loop count and affinity.
* ``mem_pressure`` — seeded host pauses on the staged emission's
  wire-buffer allocations (``pipeline.set_alloc_hook``). Under the
  SUPERVISED runner the first event escalates to a pool-exhaustion raise
  the supervisor must heal with its retry budget.

Where the seams act. The reference's flush fault and allocation hook act
while JAX traces a serve step, once per new shape; the port runs
eagerly and consults them on every call. So for ``dropped_flush`` and
``mem_pressure`` a plan's step is a per-call consult index here and a
per-trace one there, and :class:`ChaosResult`'s ``fired`` and
``emissions`` differ from the reference's for those two scenarios by
design. The plans, the served tokens, the drain traces and the fired
traces of the four runtime-seam scenarios (``slow_channel``,
``stalled_loop``, ``admission_storm``, ``reshard_mid_request``) are the
reference's: the completion waits sit at the same three sites of both
engines. Under :func:`run_supervised` the same holds for the healing
trace: the runtime-seam scenarios' traces are the reference's, while
for ``dropped_flush`` and ``mem_pressure`` the supervisor's ``reflush``
actions (whose target is the round's drop count) follow the per-call
drops.

A run takes ``device`` and ``ring`` (the reference's mesh): the sliced
``hadronio`` wire needs a ring of peers (a one-peer ring on one card).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.compat import DeviceLike
from repro_torch.configs.base import CommConfig, ModelConfig, ServeConfig
from repro_torch.core import channels as channels_mod
from repro_torch.core.backends import pipeline
from repro_torch.core.channels import Ring
from repro_torch.launch.elastic import reshard_affinity, reshard_event_loops
from repro_torch.obs.metrics import RingLog
from repro_torch.serving import slo
from repro_torch.serving.engine import Request, make_engine_group
from repro_torch.serving.event_loop import EventLoopGroup

SCENARIOS = ("slow_channel", "stalled_loop", "dropped_flush",
             "admission_storm", "reshard_mid_request", "mem_pressure")

STORM_UID_BASE = 1_000_000   # injected storm traffic lives above this uid


class ChaosMemPressure(MemoryError):
    """Escalated mem_pressure event: the wire-buffer pool is exhausted,
    raised from the allocation seam so the drain fails (supervised runs
    only)."""


class ChaosFlushError(RuntimeError):
    """Injected one-shot drain failure (supervised dropped_flush)."""


# ---------------------------------------------------------------------------
# The seeded plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Injection:
    """One planned fault. ``step`` is scenario-local: a completion-wait
    index (slow_channel / stalled_loop), a flush_ready consult index
    (dropped_flush), a flush-boundary step (admission_storm), the
    request split point (reshard_mid_request), or a wire-buffer
    allocation consult index (mem_pressure)."""
    step: int
    target: int        # channel id / loop id / burst size / new loop count
    kind: str          # delay | stall | drop | dup | burst | resize | pressure
    magnitude: float   # seconds (delay/stall/pressure), req count (burst)


@dataclass(frozen=True)
class ChaosPlan:
    scenario: str
    seed: int
    events: tuple

    def trace(self) -> tuple:
        """The canonical injection trace — what deterministic replay
        compares: same seed => equal traces, element for element."""
        return tuple((e.step, e.target, e.kind, round(e.magnitude, 9))
                     for e in self.events)


def make_plan(scenario: str, seed: int, *, n_channels: int = 4,
              n_loops: int = 1, n_requests: int = 4, horizon: int = 16,
              n_events: int = 4, delay_s: tuple = (0.5e-3, 2e-3),
              stall_s: float = 1e-3, max_burst: int = 2,
              loop_choices: tuple = (1, 2, 4)) -> ChaosPlan:
    """Derive the whole injection trace from ONE numpy Generator: every
    sample below is a function of ``seed``, so the plan (and the runtime
    trace it drives) replays exactly. Each scenario pins one early event
    so at least one fault lands inside the run's horizon."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown chaos scenario {scenario!r}: expected "
                         f"one of {SCENARIOS}")
    rng = np.random.default_rng(seed)

    def steps(first: int) -> list:
        pool = np.arange(first + 1, max(first + 2, horizon))
        k = min(max(0, n_events - 1), pool.size)
        picked = rng.choice(pool, size=k, replace=False)
        return [first] + sorted(int(s) for s in picked)

    events: list = []
    if scenario == "slow_channel":
        target = int(rng.integers(n_channels))
        for s in steps(0):
            events.append(Injection(s, target, "delay",
                                    float(rng.uniform(*delay_s))))
    elif scenario == "stalled_loop":
        target = int(rng.integers(n_loops))
        for s in steps(0):
            events.append(Injection(s, target, "stall",
                                    float(stall_s * rng.uniform(0.5, 1.5))))
    elif scenario == "dropped_flush":
        kinds = ("drop", "dup")
        for s in steps(0):
            events.append(Injection(s, -1, kinds[int(rng.integers(2))],
                                    0.0))
    elif scenario == "admission_storm":
        # boundary steps start at 1 (the first polled flush boundary)
        for s in steps(1):
            events.append(Injection(s, int(rng.integers(1, max_burst + 1)),
                                    "burst", 0.0))
    elif scenario == "reshard_mid_request":
        valid = [l for l in loop_choices if 1 <= l <= n_channels]
        other = [l for l in valid if l != n_loops] or valid
        new_loops = int(other[int(rng.integers(len(other)))])
        split = int(rng.integers(1, max(2, n_requests)))
        events.append(Injection(split, new_loops, "resize", 0.0))
    else:   # mem_pressure: pauses on wire-buffer allocations
        for s in steps(0):
            events.append(Injection(s, -1, "pressure",
                                    float(rng.uniform(*delay_s))))
    return ChaosPlan(scenario=scenario, seed=seed, events=tuple(events))


# ---------------------------------------------------------------------------
# Runtime injection
# ---------------------------------------------------------------------------


class _Injector:
    """Arms one plan against a live engine group and records what
    actually fired (inline drains make the fire order deterministic).
    ``fired`` and ``emissions`` are bounded :class:`RingLog` s;
    ``drains`` stays a plain list."""

    def __init__(self, plan: ChaosPlan, vocab_size: int, max_new: int = 1,
                 evidence_capacity: int = 65536):
        self.plan = plan
        self.vocab_size = vocab_size
        self.max_new = max_new
        self.by_step = {e.step: e for e in plan.events}
        self.fired = RingLog(evidence_capacity)
        self.drains: list = []
        self.emissions = RingLog(evidence_capacity)
        self._wait_counts: dict = {}
        self._flush_calls = 0
        self._storm_uids = 0
        self._alloc_calls = 0
        self._crashed = False

    # -- Poller.fault (slow_channel / stalled_loop) ---------------------

    def poller_fault(self, loop_index: int):
        def fault(poller):
            c = self._wait_counts.get(id(poller), 0)
            self._wait_counts[id(poller)] = c + 1
            e = self.by_step.get(c)
            if e is None:
                return None
            time.sleep(e.magnitude)
            self.fired.append((c, loop_index, e.kind))
            return e.kind        # feeds PollStats (stalls / delays)
        return fault

    # -- pipeline flush fault (dropped_flush) ----------------------------

    def flush_fault(self, channel: int) -> Optional[str]:
        c = self._flush_calls
        self._flush_calls += 1
        e = self.by_step.get(c)
        if e is None:
            return None
        self.fired.append((c, channel, e.kind))
        return e.kind

    # -- pipeline alloc hook (mem_pressure) ------------------------------

    def alloc_fault(self, *, escalate: bool = False):
        """Buffer-pool hook (``pipeline.set_alloc_hook``), consulted by
        allocation index: ``pressure`` events sleep. With
        ``escalate=True`` (supervised runs) the FIRST planned event
        raises :class:`ChaosMemPressure` instead, and a retried drain
        consults past it."""
        state = {"oom": escalate}

        def hook(channel: int, nbytes: int) -> None:
            c = self._alloc_calls
            self._alloc_calls += 1
            e = self.by_step.get(c)
            if e is None:
                return
            if state["oom"]:
                state["oom"] = False
                self.fired.append((c, channel, "oom"))
                raise ChaosMemPressure(
                    f"wire-buffer pool exhausted at alloc {c} "
                    f"(channel {channel}, {nbytes} B)")
            time.sleep(e.magnitude)
            self.fired.append((c, channel, e.kind))
        return hook

    # -- one-shot drain crash (supervised dropped_flush) -----------------

    def drain_crash_hook(self):
        """Drain hook that raises ONCE, on its loop's first drain, after
        recording the drain. One-shot across group rebuilds (injector
        state, not loop state), so a retry succeeds."""
        def hook(loop, items) -> None:
            self.drains.append((loop.index, len(items)))
            if not self._crashed:
                self._crashed = True
                self.fired.append((0, loop.index, "flush_crash"))
                raise ChaosFlushError(
                    f"injected send-thread failure on loop {loop.index}")
        return hook

    # -- engine admission hook (admission_storm) -------------------------

    def admission_storm(self, engine, step: int) -> list:
        e = self.by_step.get(step)
        if e is None or e.kind != "burst":
            return []
        burst = []
        for k in range(int(e.target)):
            rng = np.random.default_rng(
                self.plan.seed * 100_003 + step * 31 + k)
            plen = int(rng.integers(2, 6))
            prompt = rng.integers(0, self.vocab_size, size=plen)
            uid = STORM_UID_BASE + self._storm_uids
            self._storm_uids += 1
            burst.append(Request(uid=uid, prompt=prompt.astype(np.int32),
                                 max_new=self.max_new))
        self.fired.append((step, len(burst), "burst"))
        return burst

    # -- observers --------------------------------------------------------

    def drain_hook(self, loop, items) -> None:
        self.drains.append((loop.index, len(items)))

    def collective_hook(self, channel: int, kind: str) -> None:
        self.emissions.append((channel, kind))


# ---------------------------------------------------------------------------
# Scenario runners
# ---------------------------------------------------------------------------


def chaos_serve_config(mode: str, event_loops: int, *, channels: int = 4,
                       poll: str = "busy", max_batch: int = 2,
                       max_len: int = 48,
                       slice_bytes: int = 128) -> ServeConfig:
    """The harness's serve shape: channel-granularity flushes on the
    ready schedule (so ``flush_ready``, the dropped-flush seam, is live)
    over a ``channels``-lane pool. ``slice_bytes`` and ``max_len`` are
    sized for a tiny model; a full-width run passes its own."""
    return ServeConfig(
        event_loops=event_loops, poll=poll, max_batch=max_batch,
        max_len=max_len,
        comm=CommConfig(mode=mode, channels=channels,
                        slice_bytes=slice_bytes, aggregate="channel",
                        flush="ready"))


def make_requests(n: int, *, vocab_size: int, seed: int = 1234,
                  max_new: tuple = (3, 5),
                  prompt_len: tuple = (3, 8)) -> list:
    """Deterministic greedy client traffic (temperature 0: equal tokens
    are the recovery invariant)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1]))
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(0, vocab_size, size=plen).astype(np.int32),
            max_new=int(rng.integers(max_new[0], max_new[1] + 1))))
    return reqs


@dataclass
class Baseline:
    """The fault-free reference: served tokens per uid (the recovery
    target) and, optionally, the per-drain RTT samples the inflation
    bound divides by (``rtts=[]``: tokens only)."""
    tokens: Dict[int, tuple]
    rtts: list = field(default_factory=list)


@dataclass
class ChaosResult:
    """One scenario run. ``fired`` is the runtime injection trace,
    ``drains`` the ``(loop, batch)`` drain trace, ``emissions`` the
    ``(channel, kind)`` trace of every channel collective issued while
    the run was armed. The port consults the flush fault and the alloc
    hook on every call where the reference consults them per trace, so
    for ``dropped_flush`` and ``mem_pressure`` ``fired`` and
    ``emissions`` count other consult indices than the reference's (the
    module docstring); ``emissions`` is non-empty whenever a sliced wire
    served."""
    plan: ChaosPlan
    fired: tuple
    drains: tuple
    report: slo.SLOReport
    tokens: Dict[int, tuple]
    rtts: list
    moved_channels: tuple = ()   # reshard only: migrated channel ids
    poll_stats: object = None    # merged PollStats (stalls evidence)
    emissions: tuple = ()


def _wrap_timing(grp: EventLoopGroup, rtts: list) -> None:
    """Per-request RTT: each client request is charged its drain batch's
    wall clock (the engine serves a drain as one continuous batch)."""
    for loop in grp.loops:
        orig = loop.runner

        def timed(l, items, _orig=orig):
            t0 = time.perf_counter()
            out = _orig(l, items)
            dt = time.perf_counter() - t0
            rtts.extend(dt for r in out
                        if getattr(r, "uid", 0) < STORM_UID_BASE)
            return out
        loop.runner = timed


def _tokens_of(results: list) -> Dict[int, tuple]:
    return {r.uid: tuple(int(t) for t in r.tokens) for r in results
            if r.uid < STORM_UID_BASE}


def run_baseline(cfg: ModelConfig, params, serve: ServeConfig,
                 reqs: Sequence[Request], *, device: DeviceLike = None,
                 ring: Optional[Ring] = None,
                 threads: bool = False) -> Baseline:
    """The fault-free run: the token reference and the RTT baseline."""
    grp = make_engine_group(cfg, params, serve, device=device, ring=ring)
    rtts: list = []
    _wrap_timing(grp, rtts)
    grp.submit(list(reqs))
    res = grp.run(threads=threads)
    return Baseline(tokens=_tokens_of(res), rtts=rtts)


def run_scenario(scenario: str, cfg: ModelConfig, params,
                 serve: ServeConfig, reqs: Sequence[Request], *,
                 seed: int, baseline: Baseline, device: DeviceLike = None,
                 ring: Optional[Ring] = None, threads: bool = False,
                 horizon: int = 16) -> ChaosResult:
    """Run ONE seeded fault scenario against a fresh engine group and
    report recovery. The plan is derived before anything runs; inline
    drains (``threads=False``, the default) keep the runtime trace
    deterministic, so same-seed runs replay exactly. Every seam armed
    here is cleared in a ``finally``."""
    plan = make_plan(scenario, seed, n_channels=serve.comm.channels,
                     n_loops=serve.event_loops, n_requests=len(reqs),
                     horizon=horizon)
    inj = _Injector(plan, cfg.vocab_size)
    rtts: list = []
    channels_mod.set_collective_hook(inj.collective_hook)
    try:
        if scenario == "dropped_flush":
            pipeline.set_flush_fault(inj.flush_fault)
        elif scenario == "mem_pressure":
            pipeline.set_alloc_hook(inj.alloc_fault())
        try:
            if scenario == "reshard_mid_request":
                res, moved, poll = _run_reshard(plan, cfg, params, serve,
                                                reqs, inj, rtts, device,
                                                ring, threads)
            else:
                grp = make_engine_group(cfg, params, serve, device=device,
                                        ring=ring)
                _wrap_timing(grp, rtts)
                for loop in grp.loops:
                    loop.drain_hook = inj.drain_hook
                moved = ()
                _arm(scenario, grp, inj)
                grp.submit(list(reqs))
                res = grp.run(threads=threads)
                poll = grp.poll_stats()
        finally:
            if scenario == "dropped_flush":
                pipeline.clear_flush_fault()
            elif scenario == "mem_pressure":
                pipeline.clear_alloc_hook()
    finally:
        channels_mod.clear_collective_hook()

    tokens = _tokens_of(res)
    report = slo.make_report(
        scenario=scenario, seed=seed, mode=serve.comm.mode,
        event_loops=serve.event_loops, reference=baseline.tokens,
        served=tokens, fault_rtts=rtts, baseline_rtts=baseline.rtts,
        n_injected=len(inj.fired))
    return ChaosResult(plan=plan, fired=tuple(inj.fired),
                       drains=tuple(inj.drains), report=report,
                       tokens=tokens, rtts=rtts, moved_channels=moved,
                       poll_stats=poll, emissions=tuple(inj.emissions))


def _arm(scenario: str, grp: EventLoopGroup, inj: _Injector) -> None:
    plan = inj.plan
    if scenario == "slow_channel":
        target = plan.events[0].target
        owner = next(l for l in grp.loops if target in l.channels)
        owner.poller.fault = inj.poller_fault(owner.index)
    elif scenario == "stalled_loop":
        target = plan.events[0].target % grp.n_loops
        grp.loops[target].poller.fault = inj.poller_fault(target)
    elif scenario == "admission_storm":
        for loop in grp.loops:
            loop.engine.admission_hook = inj.admission_storm
    # dropped_flush / mem_pressure are armed globally by run_scenario;
    # reshard is driven by its runner


def _run_reshard(plan: ChaosPlan, cfg, params, serve, reqs, inj, rtts,
                 device, ring, threads):
    """Serve the head of the queue on the original fleet, resize at the
    wave boundary, serve the tail on the rebuilt group pinned to the
    minimal-migration affinity. The union of results must equal the
    fault-free run's."""
    e = plan.events[0]
    split = max(1, min(len(reqs) - 1, e.step)) if len(reqs) > 1 else 0
    new_loops = int(e.target)

    grp = make_engine_group(cfg, params, serve, device=device, ring=ring)
    _wrap_timing(grp, rtts)
    for loop in grp.loops:
        loop.drain_hook = inj.drain_hook
    grp.submit(list(reqs[:split]))
    head = grp.run(threads=threads) if split else []

    serve2 = reshard_event_loops(serve, new_loops)
    old_aff = tuple(l.channels for l in grp.loops)
    new_aff, moved = reshard_affinity(serve.comm.channels, old_aff,
                                      new_loops)
    inj.fired.append((split, new_loops, "resize"))

    grp2 = make_engine_group(cfg, params, serve2, device=device, ring=ring,
                             affinity=new_aff)
    if tuple(l.channels for l in grp2.loops) != new_aff:
        raise RuntimeError(f"the rebuilt group's affinity "
                           f"{tuple(l.channels for l in grp2.loops)} is "
                           f"not the resharded {new_aff}")
    _wrap_timing(grp2, rtts)
    for loop in grp2.loops:
        loop.drain_hook = inj.drain_hook
    grp2.submit(list(reqs[split:]))
    tail = grp2.run(threads=threads)
    poll = grp.poll_stats().merge(grp2.poll_stats())
    return list(head) + list(tail), moved, poll


# ---------------------------------------------------------------------------
# Supervised runs — the same plans, healed by the Supervisor itself
# ---------------------------------------------------------------------------


@dataclass
class SupervisedResult:
    """One scenario run under the self-healing supervisor. ``trace`` is
    the supervisor's CANONICAL healing trace (round, kind, target,
    detail; wall-clock stamps excluded), the seed-deterministic evidence
    that the supervisor, not the harness, did the healing."""
    plan: ChaosPlan
    fired: tuple
    drains: tuple
    trace: tuple
    outcomes: Dict[int, object]
    report: slo.SLOReport
    tokens: Dict[int, tuple]
    rtts: list
    poll_stats: object = None
    emissions: tuple = ()


def run_supervised(scenario: str, cfg: ModelConfig, params,
                   serve: ServeConfig, reqs: Sequence[Request], *,
                   seed: int, baseline: Baseline, device: DeviceLike = None,
                   ring: Optional[Ring] = None, threads: bool = False,
                   horizon: int = 16, config=None) -> SupervisedResult:
    """Run one seeded scenario with the :class:`Supervisor` closing the
    detect -> decide -> heal loop itself. The harness only ARMS faults
    (through the supervisor's ``fleet_hook``, so rebuilds re-arm the
    observation seams) and then submits the client requests: every
    quarantine, restart, retry, reflush, backpressure and resize in the
    result's ``trace`` was the supervisor's own decision. Two scenarios
    escalate beyond their unsupervised form so there is a real failure
    to heal: ``dropped_flush`` adds a one-shot drain crash (retry
    budget), ``mem_pressure`` escalates its first event to a
    pool-exhaustion raise (the retried drain consults past it). Inline
    drains (the default) keep the trace deterministic. Every seam armed
    here is cleared in a ``finally``."""
    from repro_torch.serving.supervisor import Supervisor, SupervisorConfig
    plan = make_plan(scenario, seed, n_channels=serve.comm.channels,
                     n_loops=serve.event_loops, n_requests=len(reqs),
                     horizon=horizon)
    inj = _Injector(plan, cfg.vocab_size)
    rtts: list = []
    if config is None:
        # >= 2 dispatch rounds so detection and healing happen MID-stream
        config = SupervisorConfig(
            dispatch_quantum=max(1, (len(reqs) + 1) // 2))
    sup = Supervisor(cfg, params, serve, device=device, ring=ring,
                     config=config, seed=seed)

    def fleet_hook(grp):
        _wrap_timing(grp, rtts)
        for loop in grp.loops:
            loop.drain_hook = inj.drain_hook
        _arm(scenario, grp, inj)
        if scenario == "dropped_flush":
            grp.loops[0].drain_hook = inj.drain_crash_hook()

    sup.fleet_hook = fleet_hook
    channels_mod.set_collective_hook(inj.collective_hook)
    try:
        if scenario == "dropped_flush":
            pipeline.set_flush_fault(inj.flush_fault)
        elif scenario == "mem_pressure":
            pipeline.set_alloc_hook(inj.alloc_fault(escalate=True))
        try:
            if scenario == "reshard_mid_request":
                e = plan.events[0]
                sup.request_resize(int(e.target))
                inj.fired.append((1, int(e.target), "resize"))
            sup.submit(list(reqs))
            res = sup.run(threads=threads)
        finally:
            if scenario == "dropped_flush":
                pipeline.clear_flush_fault()
            elif scenario == "mem_pressure":
                pipeline.clear_alloc_hook()
    finally:
        channels_mod.clear_collective_hook()

    tokens = _tokens_of(res)
    report = slo.make_report(
        scenario=scenario, seed=seed, mode=serve.comm.mode,
        event_loops=serve.event_loops, reference=baseline.tokens,
        served=tokens, fault_rtts=rtts, baseline_rtts=baseline.rtts,
        n_injected=len(inj.fired), healing_actions=len(sup.trace),
        mttr_s=sup.mttr_s())
    return SupervisedResult(plan=plan, fired=tuple(inj.fired),
                            drains=tuple(inj.drains),
                            trace=sup.healing_trace(),
                            outcomes=dict(sup.outcomes), report=report,
                            tokens=tokens, rtts=rtts,
                            poll_stats=sup.poll_stats(),
                            emissions=tuple(inj.emissions))
