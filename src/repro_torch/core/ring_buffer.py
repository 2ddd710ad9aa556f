"""Ring-buffer slice planning — hadroNIO's 8 MiB ring buffer with 64 KiB
slices (paper §V-B), read for gradient traffic.

Counterpart of ``repro/core/ring_buffer.py`` (same rule, same numbers).
The flattened gradient is a virtual ring buffer: ``slice_bytes`` is the
aggregation granularity (one collective per slice) and
``capacity_bytes`` bounds the slices in flight. A payload that needs
more slices than the capacity admits grows the slice (recorded in the
plan) instead of blocking the writer as the paper's ring would.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import CommConfig

ALIGN_BYTES = 512   # a capacity-grown slice is rounded up to this many bytes


@dataclass(frozen=True)
class SlicePlan:
    total_bytes: int          # payload bytes (one sync dtype)
    slice_bytes: int          # effective slice size after capacity clamp
    n_slices: int
    requested_slice_bytes: int
    clamped: bool             # True if capacity forced slice growth
    align_pad_bytes: int = 0  # bytes the 512-B rounding added to a
    #                           capacity-grown slice (0 when unclamped)


def plan_slices(total_bytes: int, comm: CommConfig) -> SlicePlan:
    req = comm.slice_bytes
    max_inflight = max(1, comm.ring_capacity_bytes // req)
    n = max(1, -(-total_bytes // req))
    clamped = n > max_inflight
    align_pad = 0
    if clamped:
        n = max_inflight
        eff = -(-total_bytes // n)
        aligned = -(-eff // ALIGN_BYTES) * ALIGN_BYTES
        align_pad = aligned - eff
        eff = aligned
    else:
        eff = req
    return SlicePlan(total_bytes=total_bytes, slice_bytes=eff, n_slices=n,
                     requested_slice_bytes=req, clamped=clamped,
                     align_pad_bytes=align_pad)
