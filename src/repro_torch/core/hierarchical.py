"""Pod-aware two-level collectives.

Counterpart of ``repro/core/hierarchical.py``. Cross-pod links are
scarcer than in-pod ones, as the paper's multi-rail transport selection
in UCX assumes. An all-reduce over (pod, data) is decomposed into a
reduce-scatter inside the pod, an all-reduce across pods on
``1/in-pod`` of the bytes, and an all-gather inside the pod, so the
cross-pod traffic drops by the in-pod width.

The reference names mesh axes; here each level is a process group of
the ring (``core/channels.Ring``): ``data_group`` holds this peer's pod,
``pod_group`` the peers of the other pods at this peer's in-pod index
(None: no pod axis, a flat ring over ``data_group``). A stage is waited
on before the next is issued: on NCCL that makes the current stream wait
for the stage (the host goes on), on gloo it blocks until the stage is
done. Each function returns ``(work, out)``: ``out`` is valid once the
last stage's work is waited on. Payloads are flat, as the channels'
wire buffers are (the reference's (..., S) with no leading dims).

``psum_hierarchical`` zero-pads a length that does not divide by
the in-pod size (serving payloads have any length): the zero tail
scatters onto the last shard, is summed across pods as zeros, and is
trimmed after the gather, so padded and unpadded inputs see the same
per-element sums. ``psum_scatter_hierarchical`` keeps the divisibility
requirement: its result is a ``1/n`` shard, whose meaning padding would
change. :func:`all_gather_data` is the ZeRO-1 gather epilogue's
peer-major all-gather.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def in_group_size(group: Optional[dist.ProcessGroup]) -> int:
    """The number of peers of ``group`` (the reference's psum-of-1)."""
    return dist.get_world_size(group)


def _flat(x: torch.Tensor, what: str) -> None:
    if x.dim() != 1:
        raise ValueError(f"{what} takes a flat payload (the channels' wire "
                         f"buffers), got {tuple(x.shape)}")


def psum_hierarchical(x: torch.Tensor, pod_group: Optional[dist.ProcessGroup],
                      data_group: dist.ProcessGroup):
    """All-reduce the flat ``x`` over (pod, data), pod-aware: in-pod
    reduce-scatter, cross-pod all-reduce of the shard, in-pod all-gather.
    A length that does not divide by the in-pod size is zero-padded for
    the scatter and trimmed after the gather. ``x`` is not written.
    Returns ``(work, out)``, ``out`` shaped like ``x``."""
    _flat(x, "psum_hierarchical")
    if pod_group is None:
        out = x.clone()
        return dist.all_reduce(out, group=data_group, async_op=True), out
    group = in_group_size(data_group)
    s = x.numel()
    pad = (-s) % group
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    shard = x.new_empty(x.numel() // group)
    dist.reduce_scatter_tensor(shard, x.contiguous(), group=data_group,
                               async_op=True).wait()
    dist.all_reduce(shard, group=pod_group, async_op=True).wait()
    full = shard.new_empty(x.numel())
    work = dist.all_gather_into_tensor(full, shard, group=data_group,
                                       async_op=True)
    return work, full[:s]


def psum_scatter_hierarchical(x: torch.Tensor,
                              pod_group: Optional[dist.ProcessGroup],
                              data_group: dist.ProcessGroup):
    """Reduce-scatter the flat ``x`` over the pod (plus a cross-pod
    all-reduce of the shard): this peer keeps chunk ``in-pod index`` of
    ``in-pod size`` chunks. The length MUST divide by the in-pod size:
    the result is a ``1/n`` shard, so padding cannot be hidden from the
    caller (the ring plan pads slices to the alignment). Returns
    ``(work, shard)``."""
    _flat(x, "psum_scatter_hierarchical")
    group = in_group_size(data_group)
    if x.numel() % group != 0:
        raise ValueError(
            f"psum_scatter_hierarchical: trailing dim {x.numel()} is not "
            f"divisible by the in-pod ring size {group}; scatter shards "
            "cannot be transparently padded — pad the payload to the "
            "alignment first (aggregation.make_plan does)")
    shard = x.new_empty(x.numel() // group)
    work = dist.reduce_scatter_tensor(shard, x.contiguous(), group=data_group,
                                      async_op=True)
    if pod_group is not None:
        work.wait()
        work = dist.all_reduce(shard, group=pod_group, async_op=True)
    return work, shard


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
