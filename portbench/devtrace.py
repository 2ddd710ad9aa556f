"""The device trace of a traced run, read raw.

A traced run profiles a steady sub-window of its measured window with
``torch.profiler`` on the card alone, and reads each device event's
name, start and end off the profiler's raw results (the way the
program's ``chip_smoke.device_events`` does: a Python object per event
through ``prof.events()`` costs seconds per ten thousand kernels). From
them: the seconds in which an operation ran (the union of the events'
intervals), the idle gaps between them, each named by the program span
the host was inside at the gap's middle, and the device time by kernel
name.
"""
from __future__ import annotations

import time
from typing import Optional

import torch


def raw_events(prof) -> list:
    """[(name, start_s, end_s)] of every event on the card, seconds from
    the trace's start."""
    cuda = torch.autograd.DeviceType.CUDA
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        return []
    evs = [e for e in res.events() if e.device_type() == cuda
           and not getattr(e, "is_hidden_event", lambda: False)()]
    if not evs:
        return []
    start = getattr(res, "trace_start_ns", None)
    t0 = start() if start is not None else min(e.start_ns() for e in evs)
    return [(e.name(), (e.start_ns() - t0) / 1e9, (e.end_ns() - t0) / 1e9)
            for e in evs]


class Window:
    """Profiles from the first ``tick`` at or past ``start_at`` to the
    first at or past ``stop_at`` (host ``perf_counter`` seconds), or
    ``begin()``/``end()`` by hand. Off when ``on`` is False."""

    def __init__(self, on: bool, start_at: float = 0.0,
                 stop_at: float = 0.0):
        self.on = on
        self.start_at, self.stop_at = start_at, stop_at
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.events: list = []

    def tick(self, now: float) -> None:
        if not self.on:
            return
        if self.t_start is None and now >= self.start_at:
            self.begin()
        elif self.t_start is not None and self.t_stop is None \
                and now >= self.stop_at:
            self.end()

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = time.perf_counter()

    def end(self) -> None:
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()
        # device times are taken from the trace's start, which the host
        # reads as t_start
        self.events = [(n, self.t_start + a, self.t_start + b)
                       for n, a, b in raw_events(self.prof)]
        self.prof = None

    @property
    def window_s(self) -> Optional[float]:
        if self.t_start is None or self.t_stop is None:
            return None
        return self.t_stop - self.t_start


def warm_profiler() -> None:
    """The profiler's first start loads and sets up CUPTI: do it in the
    set-up, not in the window."""
    w = Window(True)
    w.begin()
    torch.ones(1, device="cuda").add_(1)
    w.end()


def busy_intervals(events: list, lo: float, hi: float) -> list:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: list = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def host_activity(spans: list, t: float) -> str:
    """The innermost program span (kind) that holds host time ``t``;
    ``spans`` are (kind, t0, t1). Outside every span: the harness."""
    best = None
    for kind, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (kind, a, b)
    return best[0] if best else "outside the program's spans"


def by_name(win: Window) -> list:
    """[(name, device seconds, events)] of the trace, most time first."""
    acc: dict = {}
    for n, a, b in win.events:
        s, c = acc.get(n, (0.0, 0))
        acc[n] = (s + (b - a), c + 1)
    return sorted(((n, s, c) for n, (s, c) in acc.items()),
                  key=lambda x: -x[1])


def breakdown(win: Window, spans: list, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing."""
    ops = [(n, s) for n, s, _ in by_name(win)[:top]]
    lo, hi = win.t_start, win.t_stop
    idle = sorted(gaps(busy_intervals(win.events, lo, hi), lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[host_activity(spans, (a + b) / 2), b - a]
                          for a, b in idle]}


def busy_s(win: Window) -> Optional[float]:
    if win.window_s is None:
        return None
    return sum(b - a for a, b in busy_intervals(win.events, win.t_start,
                                                win.t_stop))


def kernel_s(win: Window, match) -> float:
    """Device seconds of the events whose name ``match`` accepts."""
    return sum(b - a for n, a, b in win.events if match(n))
