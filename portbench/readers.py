"""What the metric readers share: reductions of a run's record.

A record is the dict a runner (``serve.py``, ``train.py``) returns under
``record``: the window's host times, the requests or steps, the
program's spans (kind, start, end on the host clock), its counters, and
the device trace of a traced run (``devtrace.Window``). A reader that
finds nothing to read returns None, and the harness leaves its metric
out of the line.
"""
from __future__ import annotations

import re

import numpy as np

from portbench import devtrace, flops


def span_mean_ms(rec: dict, kinds: tuple):
    d = [b - a for k, a, b in rec["spans"] if k in kinds
         and rec["t0"] <= a <= rec.get("t_drained", rec["t_end"])]
    return float(np.mean(d)) * 1e3 if d else None


def span_sum_s(rec: dict, kinds: tuple) -> float:
    return sum(b - a for k, a, b in rec["spans"] if k in kinds
               and rec["t0"] <= a <= rec.get("t_drained", rec["t_end"]))


def rows_per_decode_step(rec: dict):
    steps = rec["counters"][2]
    return rec["decode_tokens"] / steps if steps else None


def device_idle_pct(rec: dict):
    win = rec["win"]
    busy = devtrace.busy_s(win)
    if busy is None or not win.events:
        return None
    return 100.0 * (1.0 - busy / win.window_s)


def kernel_share_pct(rec: dict, match):
    win = rec["win"]
    busy = devtrace.busy_s(win)
    if not busy:
        return None
    return 100.0 * devtrace.kernel_s(win, match) / busy


def is_flash(name: str) -> bool:
    """The flash-attention kernels (``kernels/csrc/flash_attention.cu``),
    by their names as the trace gives them (demangled signatures)."""
    return re.search(r"\bflash_fwd_(tc|f32)\b", name) is not None


def is_ring_pack(name: str) -> bool:
    """The ring pack and unpack kernels (``kernels/csrc/ring_pack.cu``)."""
    return re.search(r"\b(un)?pack_kernel\b", name) is not None


def is_exchange(name: str) -> bool:
    return is_ring_pack(name) or "nccl" in name.lower()


def per_step_ms(rec: dict, match):
    n = rec.get("profiled_steps", 0)
    if not n or not rec["win"].events:
        return None
    return devtrace.kernel_s(rec["win"], match) / n * 1e3


def prefilled(rec: dict) -> list:
    return [r for r in rec["handed"]
            if rec["t0"] <= r.first <= rec["t_drained"]]


def mfu_prefill_pct(rec: dict):
    t = span_sum_s(rec, ("prefill", "admission"))
    if not t:
        return None
    work = sum(flops.prefill_flops(rec["cfg"], len(r.prompt))
               for r in prefilled(rec))
    return 100.0 * work / t / flops.PEAK_BF16_FLOPS


def mfu_serve_pct(rec: dict):
    reqs = prefilled(rec)
    if not reqs:
        return None
    work = sum(flops.request_flops(rec["cfg"], len(r.prompt), r.produced)
               for r in reqs)
    return 100.0 * work / (rec["t_drained"] - rec["t0"]) \
        / flops.PEAK_BF16_FLOPS
