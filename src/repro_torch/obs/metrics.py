"""Metrics registry for the telemetry plane.

Counterpart of ``repro/obs/metrics.py``. The serving plane's subsystems
each keep their own counters (``PollStats``, ``EmissionStats``,
``EventLoopGroup.failures``/``heartbeats``, tenant
``fairness_counters``, the supervisor's healing trace, admission and
shedding outcomes). This module gives them ONE snapshot surface without
rewriting any of them: typed metrics with a fixed label taxonomy, plus
THIN PULL-BASED ADAPTERS (the ``publish_*`` functions) that scrape the
live counters into a registry at collection time. The objects stay the
source of truth, and the registry is the unified export
(``snapshot()`` / ``to_json()``).

Determinism contract:

* **counters / gauges** are DETERMINISTIC: same seed + same ChaosPlan =>
  identical values (they count events on seeded or structural paths:
  waits, stalls, delays, drops, heal actions, fairness strides).
* **volatile gauges** carry wall-clock-COUPLED counts (busy-poll
  ``spins``, adaptive ``parks``): real telemetry, but excluded from the
  deterministic snapshot because their values depend on how fast the
  host happened to run.
* **histograms** hold wall-clock measurements (durations). Count, sum,
  min, max and percentiles are reported; nothing in them participates
  in the determinism contract.

``snapshot()`` returns ``{"counters", "gauges", "volatile",
"histograms"}``; ``deterministic_snapshot()`` returns only the first
two, the byte-comparable view (same seed => identical
``to_json(deterministic=True)`` bytes).

The port's emission counters (``emission.drops``/``dups``/``allocs``)
count per call where the reference's count per traced shape
(``repro_torch/serving/chaos.py``), so their values differ from the
reference's for the same run; their keys, and every other metric's
value, are the reference's.

:class:`RingLog` is the shared bounded evidence container (the
dispatch log, the chaos ``fired``/``emissions`` traces): list-like
(append/extend/iter/index/slice/==) with a ring capacity and a
``dropped`` eviction counter the registry exposes.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, Iterable, Optional, Tuple

# The label taxonomy. Closed on purpose: a bounded, documented label set
# is what keeps snapshots joinable across subsystems (an unknown key is
# a bug in the instrumentation, not a new dimension).
LABEL_KEYS = frozenset({"channel", "loop", "tenant", "mode", "pod",
                        "kind", "scope", "scenario", "seed"})


def _label_key(name: str, labels: Dict[str, Any]) -> str:
    for k in labels:
        if k not in LABEL_KEYS:
            raise ValueError(
                f"unknown metric label {k!r} on {name!r}: the taxonomy is "
                f"{sorted(LABEL_KEYS)} (extend LABEL_KEYS first)")
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone event count (deterministic by contract)."""
    __slots__ = ("key", "value")

    def __init__(self, key: str):
        self.key = key
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    """Point-in-time value (deterministic unless ``volatile``)."""
    __slots__ = ("key", "value", "volatile")

    def __init__(self, key: str, volatile: bool = False):
        self.key = key
        self.value = 0
        self.volatile = volatile

    def set(self, v) -> None:
        self.value = int(v) if float(v).is_integer() else float(v)


class Histogram:
    """Wall-clock distribution: bounded raw samples (ring — long serves
    must not grow memory) + running count/sum/min/max."""
    __slots__ = ("key", "count", "total", "min", "max", "_samples")

    def __init__(self, key: str, sample_capacity: int = 2048):
        self.key = key
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: deque = deque(maxlen=int(sample_capacity))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._samples.append(v)

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.min, "max": self.max}
        if self._samples:
            xs = sorted(self._samples)
            for q, lab in ((0.5, "p50"), (0.99, "p99")):
                out[lab] = xs[min(len(xs) - 1, int(q * len(xs)))]
        return out


class MetricsRegistry:
    """Typed metrics keyed by ``name{label=value,...}`` (labels sorted,
    so the key — and therefore the snapshot — is order-independent)."""

    def __init__(self, *, histogram_samples: int = 2048):
        self._histogram_samples = histogram_samples
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        key = _label_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(key, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {key!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, *, volatile: bool = False,
              **labels) -> Gauge:
        g = self._get(Gauge, name, labels, volatile=volatile)
        g.volatile = g.volatile or volatile
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         sample_capacity=self._histogram_samples)

    def clear(self) -> None:
        self._metrics.clear()

    # -- the unified view ----------------------------------------------

    def snapshot(self) -> dict:
        """``{"counters", "gauges", "volatile", "histograms"}`` — each a
        key-sorted dict. Counters + gauges are the deterministic half;
        volatile gauges and histograms carry wall-clock."""
        out: dict = {"counters": {}, "gauges": {}, "volatile": {},
                     "histograms": {}}
        for key in sorted(self._metrics):
            m = self._metrics[key]
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["volatile" if m.volatile else "gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    def deterministic_snapshot(self) -> dict:
        snap = self.snapshot()
        return {"counters": snap["counters"], "gauges": snap["gauges"]}

    def to_json(self, *, deterministic: bool = False,
                indent: Optional[int] = 1) -> str:
        snap = (self.deterministic_snapshot() if deterministic
                else self.snapshot())
        return json.dumps(snap, indent=indent, sort_keys=True)


# ---------------------------------------------------------------------------
# RingLog — the bounded evidence container
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Thin adapters: scrape the live ad-hoc counters into a registry. Pull-based
# on purpose — the producing subsystems keep their own state (and tests);
# collection is a read-only pass at snapshot time.
# ---------------------------------------------------------------------------

# PollStats fields that are deterministic (seeded/structural) vs coupled
# to host speed (busy-spin probe counts, adaptive park decisions).
_POLL_DETERMINISTIC = ("waits", "stalls", "delays")
_POLL_VOLATILE = ("spins", "parks")


def publish_poll_stats(reg: MetricsRegistry, stats, **labels) -> None:
    """One ``PollStats`` (or anything with its fields) -> ``poll.*``."""
    for f in _POLL_DETERMINISTIC:
        reg.gauge(f"poll.{f}", **labels).set(getattr(stats, f))
    for f in _POLL_VOLATILE:
        reg.gauge(f"poll.{f}", volatile=True, **labels).set(
            getattr(stats, f))


def publish_emission_stats(reg: MetricsRegistry, stats, **labels) -> None:
    """One ``pipeline.EmissionStats`` -> ``emission.*`` (trace-time
    counters: deterministic for a given program trace)."""
    for f in ("drops", "dups", "allocs"):
        reg.gauge(f"emission.{f}", **labels).set(getattr(stats, f))


def publish_pipeline(reg: MetricsRegistry, **labels) -> None:
    """The ACTIVE emission-stats scope (``pipeline.current_stats()`` —
    the module global unless a ``stats_scope`` is armed)."""
    # lazy: obs must not import the core at module load (the core
    # imports obs.trace)
    from repro_torch.core.backends import pipeline
    publish_emission_stats(reg, pipeline.current_stats(), **labels)


def publish_group(reg: MetricsRegistry, group, **labels) -> None:
    """An ``EventLoopGroup``: per-loop poll stats (lifetime — restart
    folds included), heartbeats/restarts/queue depth, failure and
    dispatch-log counters, tenant fairness."""
    for l in group.loops:
        st = l.poll_stats() if hasattr(l, "poll_stats") else l.poller.stats
        publish_poll_stats(reg, st, loop=l.index, **labels)
        reg.gauge("loop.heartbeats", loop=l.index, **labels).set(
            l.heartbeats)
        reg.gauge("loop.restarts", loop=l.index, **labels).set(l.restarts)
        reg.gauge("loop.queue_depth", loop=l.index, **labels).set(
            len(l.queue))
        eng = getattr(l, "engine", None)
        if eng is not None:
            reg.gauge("engine.admit_prefills", loop=l.index, **labels).set(
                eng.admit_prefills)
    reg.gauge("group.loops", **labels).set(group.n_loops)
    reg.gauge("group.loop_failures", **labels).set(group.loop_failures)
    for name, n in getattr(group, "fairness_counters", {}).items():
        reg.gauge("tenant.dispatched", tenant=name, **labels).set(n)
    dlog = getattr(group, "dispatch_log", None)
    if dlog is not None:
        reg.gauge("group.dispatch_log_len", **labels).set(len(dlog))
        if hasattr(dlog, "dropped"):
            reg.gauge("group.dispatch_log_dropped", **labels).set(
                dlog.dropped)


def publish_supervisor(reg: MetricsRegistry, sup, **labels) -> None:
    """A ``Supervisor``: rounds, heal actions by kind, outcomes by
    status, per-channel emission counts, shed/served totals."""
    reg.gauge("supervisor.rounds", **labels).set(sup.rounds)
    by_kind: Dict[str, int] = {}
    for a in sup.trace:
        by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
    for k, n in by_kind.items():
        reg.gauge("heal.actions", kind=k, **labels).set(n)
    reg.gauge("heal.total", **labels).set(len(sup.trace))
    by_status: Dict[str, int] = {}
    for o in sup.outcomes.values():
        by_status[o.status] = by_status.get(o.status, 0) + 1
    for s, n in by_status.items():
        reg.gauge("outcome.requests", kind=s, **labels).set(n)
    for c, n in sorted(sup.emission_counts.items()):
        reg.gauge("channel.emissions", channel=c, **labels).set(n)


def publish_chaos(reg: MetricsRegistry, result, **labels) -> None:
    """A ``ChaosResult`` / ``SupervisedResult``: injection + evidence
    counts (the fired/emissions RingLogs) and the recovery bit."""
    reg.gauge("chaos.injected", **labels).set(len(result.fired))
    reg.gauge("chaos.drains", **labels).set(len(result.drains))
    reg.gauge("chaos.emissions", **labels).set(len(result.emissions))
    reg.gauge("chaos.recovered", **labels).set(
        1 if getattr(result.report, "recovered", False) else 0)
    if result.poll_stats is not None:
        publish_poll_stats(reg, result.poll_stats, **labels)


def collect(*, group=None, supervisor=None, registry=None,
            **labels) -> MetricsRegistry:
    """The one-call snapshot builder: a fresh registry (or ``registry``)
    with everything reachable published — pipeline emission stats
    always; group and supervisor when given (a supervisor implies its
    group)."""
    reg = registry if registry is not None else MetricsRegistry()
    publish_pipeline(reg, **labels)
    if supervisor is not None:
        publish_supervisor(reg, supervisor, **labels)
        if group is None:
            group = getattr(supervisor, "group", None)
    if group is not None:
        publish_group(reg, group, **labels)
    return reg
