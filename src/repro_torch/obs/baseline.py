"""Perf-regression gate: compare two ``BENCH_*.json`` artifacts.

Counterpart of ``repro/obs/baseline.py`` (its command line stays the
reference's ``benchmarks/bench_diff.py``). A benchmark artifact is a
JSON array of rows with the shared schema ``(benchmark, figure, mode,
msg_bytes, channels, metric, value, unit, kind, seed)``. :func:`diff`
joins a candidate artifact against a baseline on the row identity
``(benchmark, figure, mode, msg_bytes, channels, metric, unit)`` (seed
excluded on purpose: reseeded rows must still be comparable) and judges
each pair against a per-metric :class:`Tolerance` band.

Default tolerance policy (override per pattern):

* ``measured`` rows in time units (us/ms/s/ns): wall clock on shared
  machines is noisy, so the band is generous (rel=1.0, a 2x slowdown
  trips the gate) and LOWER IS BETTER.
* ``derived`` rows in time units: analytic model outputs, a tight band
  (rel=0.05), lower is better.
* ``derived`` rows in structural units (ops, B, bytes, frac, slices,
  ratio, x, tok): EXACT, as deterministic functions of the config; any
  drift is a real change of behaviour.
* any row in unit ``count``: IGNORED by default (poll spins/parks are
  wall-clock-coupled, and metrics-snapshot rows are held by their own
  determinism tests).
* ``measured`` rows in other units: ignored (throughput-style rows
  mirror a time row that is already gated).
"""
from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TIME_UNITS = frozenset({"us", "ms", "s", "ns"})
EXACT_UNITS = frozenset({"ops", "B", "bytes", "frac", "slices", "ratio",
                         "x", "tok"})

Key = Tuple[str, str, str, object, object, str, str]


def row_key(row: dict) -> Key:
    return (str(row.get("benchmark", "")), str(row.get("figure", "")),
            str(row.get("mode", "")), row.get("msg_bytes"),
            row.get("channels"), str(row.get("metric", "")),
            str(row.get("unit", "")))


def key_label(key: Key) -> str:
    bench, fig, mode, msg, chans, metric, unit = key
    parts = [bench, mode, metric]
    if msg not in (None, "", 0):
        parts.append(f"{msg}B")
    if chans not in (None, "", 0):
        parts.append(f"c{chans}")
    return ":".join(str(p) for p in parts if p != "") + f" [{unit}]"


@dataclass
class Tolerance:
    """One comparison band. ``direction``:

    * ``lower_is_better`` — regression iff cand > base * (1+rel) + abs
    * ``higher_is_better`` — regression iff cand < base * (1-rel) - abs
    * ``exact`` — regression iff |cand - base| > abs
    * ``ignore`` — never a regression
    """
    rel: float = 0.0
    abs: float = 0.0
    direction: str = "lower_is_better"

    def judge(self, base: float, cand: float) -> str:
        """-> "ok" | "regression" | "improved"."""
        if self.direction == "ignore":
            return "ok"
        if self.direction == "exact":
            return "ok" if abs(cand - base) <= max(self.abs, 0.0) else \
                "regression"
        if self.direction == "higher_is_better":
            lo = base * (1.0 - self.rel) - self.abs
            hi = base * (1.0 + self.rel) + self.abs
            if cand < lo:
                return "regression"
            return "improved" if cand > hi else "ok"
        # lower_is_better
        hi = base * (1.0 + self.rel) + self.abs
        lo = base * (1.0 - self.rel) - self.abs
        if cand > hi:
            return "regression"
        return "improved" if cand < lo else "ok"


def default_tolerance(row: dict, *, tol_measured: float = 1.0,
                      tol_derived_time: float = 0.05) -> Tolerance:
    """The policy table above, parameterized on the two band widths."""
    unit = str(row.get("unit", ""))
    kind = str(row.get("kind", "measured"))
    if unit == "count":
        return Tolerance(direction="ignore")
    if unit in TIME_UNITS:
        rel = tol_measured if kind == "measured" else tol_derived_time
        return Tolerance(rel=rel, direction="lower_is_better")
    if kind == "derived" and unit in EXACT_UNITS:
        return Tolerance(abs=1e-9, direction="exact")
    return Tolerance(direction="ignore")


@dataclass
class Delta:
    key: Key
    status: str                     # ok|regression|improved|missing|added|ignored
    base: Optional[float] = None
    cand: Optional[float] = None
    tol: Optional[Tolerance] = None

    @property
    def label(self) -> str:
        return key_label(self.key)

    @property
    def change(self) -> Optional[float]:
        if self.base in (None, 0) or self.cand is None:
            return None
        return (self.cand - self.base) / self.base

    def describe(self) -> str:
        if self.status in ("missing", "added"):
            return f"{self.status:>10}  {self.label}"
        ch = self.change
        pct = "" if ch is None else f"  {ch:+.1%}"
        return (f"{self.status:>10}  {self.label}  "
                f"{self.base!r} -> {self.cand!r}{pct}")


@dataclass
class DiffReport:
    deltas: List[Delta] = field(default_factory=list)

    def of(self, status: str) -> List[Delta]:
        return [d for d in self.deltas if d.status == status]

    @property
    def regressions(self) -> List[Delta]:
        return self.of("regression")

    @property
    def ok(self) -> bool:
        return not self.regressions

    def summary(self) -> str:
        counts: Dict[str, int] = {}
        for d in self.deltas:
            counts[d.status] = counts.get(d.status, 0) + 1
        return ", ".join(f"{counts[s]} {s}" for s in
                         ("regression", "improved", "ok", "ignored",
                          "missing", "added") if s in counts)


def load_rows(path: str) -> List[dict]:
    """A ``BENCH_*.json`` artifact: a JSON array of row dicts (the
    format ``benchmarks/common.py:write_json`` emits)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):                 # tolerate {"rows": [...]}
        doc = doc.get("rows", [])
    if not isinstance(doc, list):
        raise ValueError(f"{path}: expected a JSON array of bench rows")
    return [r for r in doc if isinstance(r, dict)]


def _index(rows: List[dict]) -> Dict[Key, dict]:
    out: Dict[Key, dict] = {}
    for r in rows:
        out[row_key(r)] = r                   # last write wins (reruns)
    return out


def diff(base_rows: List[dict], cand_rows: List[dict], *,
         tol_measured: float = 1.0, tol_derived_time: float = 0.05,
         overrides: Optional[List[Tuple[str, Tolerance]]] = None,
         ignore: Optional[List[str]] = None) -> DiffReport:
    """Join candidate against baseline and judge every shared key.

    ``overrides`` is an ordered ``[(glob, Tolerance), ...]`` list —
    globs match either the bare metric or ``benchmark:metric``; the
    FIRST match wins and replaces the default policy for that row.
    ``ignore`` globs (same matching) force status "ignored".
    """
    base_ix, cand_ix = _index(base_rows), _index(cand_rows)
    rep = DiffReport()

    def _match(key: Key, pat: str) -> bool:
        bench, _, _, _, _, metric, _ = key
        return (fnmatch.fnmatch(metric, pat)
                or fnmatch.fnmatch(f"{bench}:{metric}", pat))

    for key in sorted(set(base_ix) | set(cand_ix), key=str):
        b, c = base_ix.get(key), cand_ix.get(key)
        if c is None:
            rep.deltas.append(Delta(key, "missing",
                                    base=b.get("value")))
            continue
        if b is None:
            rep.deltas.append(Delta(key, "added", cand=c.get("value")))
            continue
        if ignore and any(_match(key, p) for p in ignore):
            rep.deltas.append(Delta(key, "ignored", base=b.get("value"),
                                    cand=c.get("value")))
            continue
        tol = None
        for pat, t in (overrides or []):
            if _match(key, pat):
                tol = t
                break
        if tol is None:
            tol = default_tolerance(c, tol_measured=tol_measured,
                                    tol_derived_time=tol_derived_time)
        try:
            bv, cv = float(b.get("value")), float(c.get("value"))
        except (TypeError, ValueError):
            status = "ok" if b.get("value") == c.get("value") else \
                "regression"
            rep.deltas.append(Delta(key, status, base=b.get("value"),
                                    cand=c.get("value"), tol=tol))
            continue
        status = tol.judge(bv, cv)
        if tol.direction == "ignore":
            status = "ignored"
        rep.deltas.append(Delta(key, status, base=bv, cand=cv, tol=tol))
    return rep


def diff_files(base_path: str, cand_path: str, **kw) -> DiffReport:
    return diff(load_rows(base_path), load_rows(cand_path), **kw)
