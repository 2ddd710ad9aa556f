"""Gradient compression for the ring slices.

Counterpart of ``repro/core/compress.py``: bf16 — cast the slices to
bf16 on the wire, the f32 truncation residual re-injected the next step
(``bf16_compress``; the training path runs the same codec fused into the
pack stage, ``kernels/ref.pack_slices`` and its CUDA kernel); int8_ef —
per-slice max-abs int8 quantization with an f32 error-feedback residual,
summed through an all-gather and a local dequantize-and-sum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def bf16_compress(slices: torch.Tensor, ef: Optional[torch.Tensor]):
    """slices: (n, S) f32. Returns (wire bf16, new error feedback f32)."""
    if ef is not None:
        slices = slices + ef
    wire = slices.to(torch.bfloat16)
    return wire, slices - wire.float()


def int8_quantize(slices: torch.Tensor, ef: Optional[torch.Tensor]):
    """Returns (q int8, scale f32 (n, 1), new_ef)."""
    if ef is not None:
        slices = slices + ef
    amax = slices.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(slices / scale), -127, 127).to(torch.int8)
    return q, scale, slices - q.float() * scale


def int8_allreduce(q: torch.Tensor, scale: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum the peers' int8 slices over ``group``: all-gather the int8
    payloads and their scales, then dequantize and sum locally, peer by
    peer in ring order. q: (n, S) int8; scale: (n, 1) f32. Returns the
    f32 (n, S) sum."""
    world = dist.get_world_size(group)
    qg = [torch.empty_like(q) for _ in range(world)]
    sg = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qg, q.contiguous(), group=group)
    dist.all_gather(sg, scale.contiguous(), group=group)
    return (torch.stack(qg).float() * torch.stack(sg)).sum(dim=0)
