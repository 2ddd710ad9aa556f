"""Span tracing for the telemetry plane.

Counterpart of ``repro/obs/trace.py``. NESTED SPANS over the staged
emission API (``begin_emission`` -> ``stage_slices`` -> ``flush_ready``
-> ``finish_emission``) and the serving plane (admission -> prefill ->
decode waves, event-loop drains, supervisor heal windows), recorded into
a RING-BUFFERED :class:`TraceRecorder` and exported as Chrome-trace /
Perfetto JSON (``chrome://tracing`` / https://ui.perfetto.dev load it
directly).

Design rules:

* **Zero overhead when disabled.** The module-level gate is one global:
  ``enabled()`` is a ``None`` check, :func:`span` returns a shared
  ``nullcontext`` and :func:`begin` returns ``None`` without touching a
  clock. Instrumentation sites on hot paths guard with ``if
  trace.enabled():`` so the disabled cost is a single load+compare.
* **Observation only.** Spans record the host clock around work that
  already happens (no CUDA events: a span around asynchronous card work
  times its launch plus whatever the site waits for, as the poller's
  waits inside ``prefill``); nothing here feeds back into emission
  structure, scheduling or numerics, so traced runs serve tokens equal
  to untraced ones.
* **Call time, not trace time.** The reference's emission / stage /
  flush spans fire while JAX traces a serve step (once per shape); the
  port runs eagerly, so they fire on EVERY call, and ``build`` fires once
  per engine built (there is no serve-step cache). Span counts differ
  from the reference's by design; kinds, nesting and well-formedness are
  the same.
* **Thread safety.** Each thread keeps its own span stack (nesting is a
  per-thread property: threaded drains interleave); the span ring and
  the tid table are lock-protected. ``complete()`` records a span from
  explicit timestamps without touching any stack: the supervisor's
  detect->heal windows use it.

Span kinds in the shipped instrumentation: ``emission`` / ``stage`` /
``flush`` (``core/backends/pipeline.py``), ``build``
(``serving/dispatch.py``), ``prefill`` / ``decode`` / ``admission``
(``serving/engine.py``), ``drain`` (``serving/event_loop.py``), ``heal``
(``serving/supervisor.py``). ``leader_flush`` stays in :data:`KINDS`
for the two-level leader emission, which the port does not have yet.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# The instrumented span kinds (open set — the recorder accepts any string;
# this tuple is the documented taxonomy the smoke assertions key on).
KINDS = ("emission", "stage", "flush", "leader_flush", "build",
         "prefill", "decode", "admission", "drain", "heal")


@dataclass
class Span:
    """One closed span. Times are seconds relative to the recorder's
    epoch (``perf_counter`` at construction); ``depth`` is the nesting
    depth at close time on the recording thread (0 = top level)."""
    kind: str
    name: str
    t0: float
    dur: float
    tid: int
    depth: int
    args: dict = field(default_factory=dict)

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


class TraceRecorder:
    """Ring-buffered span recorder with per-thread nesting stacks.

    ``capacity`` bounds the ring: the oldest span is evicted per
    overflowing append and counted in ``dropped`` (long-running serves
    must never grow memory unboundedly — same rule as the evidence
    RingLogs). ``forced_closes`` counts non-LIFO closes (an ``end``
    whose token was not on top — intermediates are force-closed so the
    trace stays an interval forest); a well-formed run keeps it at 0.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self.spans: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self.forced_closes = 0
        self._epoch = time.perf_counter()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        self._stacks: Dict[int, list] = {}   # tid -> live stack (open_spans)

    # -- clocks / identity ---------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
            return self._tids[ident]

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            tid = self._tid()            # before the lock: _tid locks too
            with self._lock:
                self._stacks[tid] = st
        return st

    # -- the span API ---------------------------------------------------

    def begin(self, kind: str, name: str = "", **args) -> list:
        """Open a span; returns an opaque token for :meth:`end`."""
        tok = [kind, name, self._now(), args]
        self._stack().append(tok)
        return tok

    def end(self, token: Optional[list] = None, **extra) -> Optional[Span]:
        """Close the span ``token`` (or the top of this thread's stack).
        A non-LIFO token force-closes the intermediates above it (counted
        in ``forced_closes``); a token that is not on this thread's
        stack at all is counted and ignored — ends must never raise on
        the serving path."""
        st = self._stack()
        if token is not None and not any(t is token for t in st):
            self.forced_closes += 1
            return None
        out = None
        while st:
            top = st.pop()
            if token is None or top is token:
                out = self._emit(top, extra)
                break
            self.forced_closes += 1          # non-LIFO close
            self._emit(top, {})
        return out

    @contextlib.contextmanager
    def span(self, kind: str, name: str = "", **args):
        tok = self.begin(kind, name, **args)
        try:
            yield tok
        finally:
            self.end(tok)

    def complete(self, kind: str, name: str, t0_s: float, t1_s: float,
                 **args) -> Span:
        """Record a span from explicit ``perf_counter`` stamps, bypassing
        the nesting stacks (the supervisor's detect->heal windows carry
        their own ``t_detect``/``t_heal``)."""
        sp = Span(kind, name, t0_s - self._epoch,
                  max(0.0, t1_s - t0_s), self._tid(),
                  depth=len(self._stack()), args=dict(args))
        self._append(sp)
        return sp

    def _emit(self, tok: list, extra: dict) -> Span:
        kind, name, t0, args = tok
        if extra:
            args = {**args, **extra}
        sp = Span(kind, name, t0, self._now() - t0, self._tid(),
                  depth=len(self._stack()), args=args)
        self._append(sp)
        return sp

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self.spans) == self.capacity:
                self.dropped += 1            # ring eviction, counted
            self.spans.append(sp)

    # -- introspection --------------------------------------------------

    def open_spans(self) -> list:
        """Every thread's still-open ``(kind, name)`` pairs — the
        well-formedness probe (a clean run returns [])."""
        with self._lock:
            stacks = list(self._stacks.values())
        return [(t[0], t[1]) for st in stacks for t in st]

    def kinds(self) -> list:
        with self._lock:
            return sorted({s.kind for s in self.spans})

    def spans_of(self, kind: str) -> list:
        with self._lock:
            return [s for s in self.spans if s.kind == kind]

    # -- export ---------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome-trace JSON object (the ``traceEvents`` array of
        complete ``"ph": "X"`` events, microsecond timestamps) —
        loadable by chrome://tracing and Perfetto."""
        evs: List[dict] = []
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            evs.append({"name": s.name or s.kind, "cat": s.kind,
                        "ph": "X", "ts": round(s.t0 * 1e6, 3),
                        "dur": round(s.dur * 1e6, 3), "pid": 0,
                        "tid": s.tid, "args": dict(s.args)})
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped,
                              "forced_closes": self.forced_closes,
                              "open_spans": len(self.open_spans())}}

    def write(self, path: str) -> dict:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return doc


def well_formed(rec: TraceRecorder) -> tuple:
    """``(ok, problems)``: every opened span closed, no forced closes,
    and — per thread — spans form a proper interval forest (children
    contained in their parents; the span-tree contract the tests
    assert)."""
    problems: list = []
    open_ = rec.open_spans()
    if open_:
        problems.append(f"{len(open_)} unclosed spans: {open_[:8]}")
    if rec.forced_closes:
        problems.append(f"{rec.forced_closes} forced (non-LIFO) closes")
    eps = 1e-9
    by_tid: Dict[int, list] = {}
    for s in rec.spans:
        by_tid.setdefault(s.tid, []).append(s)
    for tid, spans in by_tid.items():
        ends: list = []                      # stack of enclosing t1s
        for s in sorted(spans, key=lambda s: (s.t0, -s.dur)):
            while ends and ends[-1] <= s.t0 + eps:
                ends.pop()
            if ends and s.t1 > ends[-1] + eps:
                problems.append(
                    f"tid {tid}: span {s.kind}:{s.name} "
                    f"[{s.t0:.6f},{s.t1:.6f}] straddles its parent "
                    f"(ends {ends[-1]:.6f})")
            ends.append(s.t1)
    return (not problems, problems)


def containing(rec: TraceRecorder, inner: Span, kind: str) -> Optional[Span]:
    """The tightest span of ``kind`` (same thread) whose interval
    contains ``inner`` — nesting queries for tests ("every leader flush
    sits inside a local flush span")."""
    eps = 1e-9
    best = None
    for s in rec.spans:
        if s.kind != kind or s.tid != inner.tid or s is inner:
            continue
        if s.t0 <= inner.t0 + eps and inner.t1 <= s.t1 + eps:
            if best is None or s.dur < best.dur:
                best = s
    return best


# ---------------------------------------------------------------------------
# The module-level gate (obs.enabled()). One global; every instrumentation
# site either checks enabled() explicitly or calls span()/begin()/end()/
# complete(), which no-op on the disabled path without touching a clock.
# ---------------------------------------------------------------------------

_RECORDER: Optional[TraceRecorder] = None
_NULL = contextlib.nullcontext()             # reusable + reentrant


def enabled() -> bool:
    return _RECORDER is not None


def enable(capacity: int = 65536) -> TraceRecorder:
    """Install a fresh recorder (replacing any active one)."""
    global _RECORDER
    _RECORDER = TraceRecorder(capacity)
    return _RECORDER


def disable() -> Optional[TraceRecorder]:
    """Remove the active recorder and return it (for export)."""
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    return rec


def recorder() -> Optional[TraceRecorder]:
    return _RECORDER


def span(kind: str, name: str = "", **args):
    """Context manager: a recorded span when enabled, a shared
    ``nullcontext`` otherwise."""
    rec = _RECORDER
    if rec is None:
        return _NULL
    return rec.span(kind, name, **args)


def begin(kind: str, name: str = "", **args):
    """Token-style open (for spans that straddle function boundaries,
    e.g. ``begin_emission`` -> ``finish_emission``); None when disabled."""
    rec = _RECORDER
    return None if rec is None else rec.begin(kind, name, **args)


def end(token, **extra) -> None:
    rec = _RECORDER
    if rec is not None and token is not None:
        rec.end(token, **extra)


def complete(kind: str, name: str, t0_s: float, t1_s: float, **args) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.complete(kind, name, t0_s, t1_s, **args)


@contextlib.contextmanager
def capture(capacity: int = 65536):
    """Scoped enable/disable (tests): yields the recorder, restores the
    previously-active one on exit."""
    global _RECORDER
    prev = _RECORDER
    rec = enable(capacity)
    try:
        yield rec
    finally:
        _RECORDER = prev
