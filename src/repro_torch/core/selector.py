"""Slice scheduling — the selector analogue (paper §III-B).

Counterpart of ``repro/core/selector.py``:

* ``emission_order`` — reverse-layer order (the last layer's gradients
  are produced first in backward).
* ``ready_groups`` — the bucket->channel grouping of the flush-when-ready
  schedule: contiguous runs of the production order, so a channel can
  flush as soon as its own run is produced (consumed by
  ``core/flush_scheduler``).

``pod_aligned_groups`` comes with the pod-aware emission (ROADMAP.md
Queue 1 item 8).

The reference's ``barrier`` (``optimization_barrier`` pinning the order
of ops for XLA) has no counterpart: PyTorch runs eagerly, so the host
issues collectives in program order, and the collectives of one channel
run in issue order on that channel's communicator.
"""
from __future__ import annotations


def emission_order(n_slices: int, reverse: bool = True) -> list[int]:
    order = list(range(n_slices))
    return order[::-1] if reverse else order


def ready_groups(n_slices: int, n_channels: int,
                 reverse: bool = False) -> tuple:
    """Partition ``emission_order(n_slices, reverse)`` into at most
    ``n_channels`` contiguous runs, balanced to within one item with the
    smaller runs first (the first channel is ready soonest)."""
    order = emission_order(n_slices, reverse)
    n_channels = max(1, min(n_channels, n_slices))
    base, rem = divmod(n_slices, n_channels)
    groups, off = [], 0
    for c in range(n_channels):
        size = base + (1 if c >= n_channels - rem else 0)
        groups.append(tuple(order[off:off + size]))
        off += size
    return tuple(groups)

