"""Ring collectives of the ZeRO-1 gather epilogue.

Counterpart of ``repro/core/hierarchical.py``, of which the port holds
only :func:`all_gather_data` (:69 there): the peer-major all-gather that
returns updated parameter shards, and synced gradient shards, to every
peer of the scatter group. The rest of that module is the pod-aware
two-level decomposition, which comes with the pod topology (ROADMAP.md
Queue 1 item 8): ``in_group_size``, ``psum_hierarchical`` and
``psum_scatter_hierarchical``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_gather_data(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate every peer's 1-D shard ``x`` peer-major (the
    reference's tiled ``all_gather`` over the scatter group's axes): the
    result's chunk ``p`` is peer ``p``'s ``x``. ``out``, if given, is the
    contiguous ``world * len(x)`` buffer to gather into."""
    if out is None:
        out = x.new_empty(dist.get_world_size(group) * x.numel())
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out
