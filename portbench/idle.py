"""The card's idle time, split by what the host was doing.

Each idle interval of a traced run's profiled sub-window (the gaps
between the device trace's busy intervals, ``devtrace``) is cut at the
program's span boundaries, and each piece goes to the innermost span
the host was inside over it: the shortest span that holds it, as
``devtrace.host_activity`` names a gap by its middle, but by exact
overlap. Pieces inside no span go to ``OUTSIDE``. The pieces of every
kind and ``OUTSIDE`` add up to the idle time ``readers.device_idle_pct``
reads.

A reader of one kind returns None on an untraced record, and on a
record whose program never opened a span of that kind (a program that
lacks the span, not an idle share of 0).
"""
from __future__ import annotations

import heapq
from typing import Optional

from portbench import devtrace

OUTSIDE = "outside the program's spans"


def idle_gaps(rec: dict) -> Optional[list]:
    """[(start, end)] of the card's idle intervals in the profiled
    sub-window (host ``perf_counter`` seconds), or None untraced."""
    win = rec["win"]
    if win.window_s is None or not win.events:
        return None
    lo, hi = win.t_start, win.t_stop
    return devtrace.gaps(devtrace.busy_intervals(win.events, lo, hi), lo, hi)


def innermost(spans: list, lo: float, hi: float) -> list:
    """[(start, end, kind)] covering [lo, hi] in order: the innermost
    span (the shortest that holds the piece) over each piece, ``OUTSIDE``
    where none does. ``spans`` are (kind, t0, t1)."""
    inside = sorted((a, b, k) for k, a, b in spans if b > lo and a < hi)
    cuts = sorted({lo, hi} | {t for a, b, _ in inside for t in (a, b)
                              if lo < t < hi})
    out: list = []
    live: list = []          # heap of (duration, end, kind), ended lazily
    nxt = 0
    for a, b in zip(cuts, cuts[1:]):
        while nxt < len(inside) and inside[nxt][0] <= a:
            s0, s1, k = inside[nxt]
            heapq.heappush(live, (s1 - s0, s1, k))
            nxt += 1
        while live and live[0][1] <= a:
            heapq.heappop(live)
        kind = live[0][2] if live else OUTSIDE
        if out and out[-1][2] == kind and out[-1][1] == a:
            out[-1] = (out[-1][0], b, kind)
        else:
            out.append((a, b, kind))
    return out


def split_s(gaps: list, spans: list, lo: float, hi: float) -> dict:
    """{kind: idle seconds}: each gap's overlap with each piece of
    :func:`innermost` over [lo, hi]."""
    out: dict = {}
    pieces = innermost(spans, lo, hi)
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, kind = pieces[j]
            ov = min(b, g1) - max(a, g0)
            if ov > 0:
                out[kind] = out.get(kind, 0.0) + ov
            j += 1
    return out


def split_pct(rec: dict) -> Optional[dict]:
    """{kind: idle share of the profiled sub-window, %}, or None
    untraced."""
    gaps = idle_gaps(rec)
    if gaps is None:
        return None
    win = rec["win"]
    return {k: 100.0 * s / win.window_s for k, s in split_s(
        gaps, rec["spans"], win.t_start, win.t_stop).items()}


def _has(rec: dict, kind: str) -> bool:
    return any(k == kind for k, _, _ in rec["spans"])


def innermost_pct(rec: dict, kind: str) -> Optional[float]:
    """The idle share (%) spent with ``kind`` the innermost span."""
    if not _has(rec, kind):
        return None
    split = split_pct(rec)
    return None if split is None else split.get(kind, 0.0)


def outside_pct(rec: dict, kind: str) -> Optional[float]:
    """The idle share (%) spent outside every span of ``kind``."""
    if not _has(rec, kind):
        return None
    gaps = idle_gaps(rec)
    if gaps is None:
        return None
    win = rec["win"]
    spans = [(k, a, b) for k, a, b in rec["spans"] if k == kind]
    covered = split_s(gaps, spans, win.t_start, win.t_stop)
    idle = sum(b - a for a, b in gaps)
    return 100.0 * (idle - covered.get(kind, 0.0)) / win.window_s
