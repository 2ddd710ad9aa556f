"""Slice scheduling — the selector analogue (paper §III-B).

Counterpart of ``repro/core/selector.py``:

* ``emission_order`` — reverse-layer order (the last layer's gradients
  are produced first in backward).
* ``ready_groups`` — the bucket->channel grouping of the flush-when-ready
  schedule: contiguous runs of the production order, so a channel can
  flush as soon as its own run is produced (consumed by
  ``core/flush_scheduler``).
* ``pod_aligned_groups`` — ``ready_groups`` that never straddle a pod
  block (the topology-aware channel affinity of
  ``serving/event_loop.channel_affinity``).

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



def pod_aligned_groups(n_slices: int, n_groups: int,
                       n_blocks: int) -> tuple:
    """:func:`ready_groups` respecting pod boundaries: partition
    ``0..n_slices-1`` into ``n_groups`` contiguous runs that never
    straddle one of ``n_blocks`` contiguous pod blocks (the blocks are
    themselves the ``ready_groups`` partition), so an event loop's owned
    channels all talk to peers of one pod. With ``n_groups >= n_blocks``
    each block is split among the groups assigned to it (balanced within
    the block); with fewer groups each group owns whole consecutive
    blocks. Either way a disjoint, covering partition of contiguous
    runs."""
    n_blocks = max(1, min(n_blocks, n_slices))
    blocks = ready_groups(n_slices, n_blocks)
    n_groups = max(1, min(n_groups, n_slices))
    if n_groups < n_blocks:
        owner_runs = ready_groups(n_blocks, n_groups)
        return tuple(tuple(i for b in run for i in blocks[b])
                     for run in owner_runs)
    # spread the groups over the blocks (balanced per block), then split
    # each block among its groups
    per_block = [len(g) for g in ready_groups(n_groups, n_blocks)]
    out = []
    for b, block in enumerate(blocks):
        base = block[0]
        out.extend(tuple(base + i for i in g)
                   for g in ready_groups(len(block), per_block[b]))
    return tuple(g for g in out if g)
