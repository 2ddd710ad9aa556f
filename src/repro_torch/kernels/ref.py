"""Plain PyTorch versions of the port's kernels, signature-identical to
``kernels/ops.py``.

Counterpart of ``repro/kernels/ref.py``. ``ops`` hands a CPU tensor to
these; ``chip_smoke.py`` and the card tests hold each CUDA kernel
against them on the same inputs.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as att


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v: (B, S, H, Dh), k/v already GQA-expanded; self-attention
    positions 0..S-1."""
    pos = torch.arange(q.shape[1], device=q.device)
    return att.attend_direct(q, k, v, pos, pos, causal=causal, window=window)
