"""SLO accounting for the serving plane: per-request RTT percentiles and
the recovery invariants the chaos harness asserts.

Counterpart of ``repro/serving/slo.py``, the same numpy code. The JIB
benchmark paper (arXiv:1910.02245) characterizes latency by
p50/p99/p99.9, never means, and asks that acceleration layers be
evaluated under identical, reproducible conditions. For a fault
scenario that gives TWO checks per run:

* **recovery** (hard, deterministic) — every request's served tokens
  equal the fault-free run's bit for bit (:func:`token_recovery`):
  drops are re-flushed at the step barrier, duplicates are idempotent,
  affinity and loop-count changes move emission structure, never
  values.
* **bounded inflation** (soft, wall clock) — the faulted run's p99.9 RTT
  may exceed the fault-free baseline's by at most a given factor
  (:func:`assert_slo`), checked only when a bound is given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

PERCENTILE_QS = (50.0, 99.0, 99.9)
PERCENTILE_LABELS = {50.0: "p50", 99.0: "p99", 99.9: "p99.9"}


def rtt_percentiles(samples: Sequence[float]) -> Dict[str, float]:
    """``{"p50": s, "p99": s, "p99.9": s}`` (seconds) over a flat sample
    stream. Small samples degrade to order statistics (one sample makes
    every percentile that sample); monotone in q by construction. Raises
    on empty input — an empty distribution has no percentiles and
    silently reporting one would fabricate a latency."""
    flat = np.asarray([float(s) for s in samples], np.float64)
    if flat.size == 0:
        raise ValueError("rtt_percentiles() of an empty sample set")
    vals = np.percentile(flat, list(PERCENTILE_QS))
    return {PERCENTILE_LABELS[q]: float(v)
            for q, v in zip(PERCENTILE_QS, vals)}


def token_recovery(reference: Dict[int, tuple],
                   served: Dict[int, tuple]) -> Tuple[bool, tuple]:
    """The hard recovery invariant: every reference request was served
    and its tokens match BIT-identically. Returns ``(recovered,
    mismatched_uids)`` — a uid is mismatched when missing from
    ``served`` or when its token sequence differs. Extra uids in
    ``served`` (absorbed storm traffic) are ignored: the invariant is
    about the original clients, not the injected load."""
    bad = tuple(sorted(
        uid for uid, toks in reference.items()
        if tuple(served.get(uid, ())) != tuple(toks)))
    return not bad, bad


def mttr(spans: Sequence[float]) -> Optional[float]:
    """Mean time-to-recovery (seconds) over per-incident detect→heal
    spans — the supervised-run analogue of the percentile summary: each
    healing action carries wall-clock (t_detect, t_heal) stamps, the
    span is their difference, and MTTR is the mean. Returns None for an
    empty span set (no incident was healed — distinct from healing
    instantly). Wall-clock, so like p99.9 inflation it is asserted with
    generous bounds only; the deterministic half of a supervised run is
    the healing TRACE (``Supervisor.healing_trace``), which excludes
    these stamps."""
    vals = [float(s) for s in spans]
    if not vals:
        return None
    return float(np.mean(vals))


@dataclass(frozen=True)
class SLOReport:
    """One scenario run's verdict: identity of the run, the recovery
    outcome, and the RTT distributions (seconds). ``baseline`` is None
    when the caller shared a token-only reference (tier-1 determinism
    tests) — inflation is then unavailable and only recovery binds.
    ``healing_actions``/``mttr_s`` describe the supervisor's detect→heal
    loop for SUPERVISED runs (0/None when unsupervised — nothing
    healed)."""
    scenario: str
    seed: int
    mode: str
    event_loops: int
    recovered: bool
    mismatched_uids: tuple
    n_injected: int
    fault: Dict[str, float]
    baseline: Optional[Dict[str, float]] = None
    healing_actions: int = 0
    mttr_s: Optional[float] = None

    @property
    def p999_inflation(self) -> Optional[float]:
        """fault p99.9 / baseline p99.9 (None without a baseline; a
        degenerate zero baseline reports 1.0 — nothing to inflate)."""
        if self.baseline is None:
            return None
        base = self.baseline["p99.9"]
        if base <= 0.0:
            return 1.0
        return self.fault["p99.9"] / base


def make_report(*, scenario: str, seed: int, mode: str, event_loops: int,
                reference: Dict[int, tuple], served: Dict[int, tuple],
                fault_rtts: Sequence[float],
                baseline_rtts: Optional[Sequence[float]] = None,
                n_injected: int = 0, healing_actions: int = 0,
                mttr_s: Optional[float] = None) -> SLOReport:
    recovered, bad = token_recovery(reference, served)
    return SLOReport(
        scenario=scenario, seed=seed, mode=mode, event_loops=event_loops,
        recovered=recovered, mismatched_uids=bad, n_injected=n_injected,
        fault=rtt_percentiles(fault_rtts),
        baseline=(rtt_percentiles(baseline_rtts)
                  if baseline_rtts else None),
        healing_actions=healing_actions, mttr_s=mttr_s)


def assert_slo(report: SLOReport, *,
               max_p999_inflation: Optional[float] = None,
               max_mttr_s: Optional[float] = None) -> None:
    """Raise AssertionError when the report violates its SLO: recovery
    always binds; the p99.9 bound binds only when a baseline exists AND
    a bound was given; the MTTR bound binds only when the report carries
    an MTTR and a bound was given (wall-clock checks are opt-in — CI
    noise must not fail the deterministic harness)."""
    assert report.recovered, (
        f"{report.scenario} seed={report.seed} mode={report.mode} "
        f"el={report.event_loops}: served tokens diverged from the "
        f"fault-free run for uids {report.mismatched_uids}")
    infl = report.p999_inflation
    if max_p999_inflation is not None and infl is not None:
        assert infl <= max_p999_inflation, (
            f"{report.scenario} seed={report.seed}: p99.9 inflated "
            f"{infl:.2f}x > bound {max_p999_inflation:.2f}x "
            f"(fault {report.fault['p99.9'] * 1e6:.1f}us vs baseline "
            f"{report.baseline['p99.9'] * 1e6:.1f}us)")
    if max_mttr_s is not None and report.mttr_s is not None:
        assert report.mttr_s <= max_mttr_s, (
            f"{report.scenario} seed={report.seed}: MTTR "
            f"{report.mttr_s:.3f}s > bound {max_mttr_s:.3f}s over "
            f"{report.healing_actions} healing actions")
