"""Public wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``. Each wrapper checks device,
dtype, shape and contiguity, then sends a CUDA tensor to its
hand-written kernel and a CPU tensor to the plain version in
``kernels/ref.py`` — the CPU path exists for the tests and is chosen
only by where the tensor lies; there is no fallback from a failed
kernel. A wrapper counts its kernel launches in a plain integer
attribute, ``<wrapper>.launches``, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

_COUNT_LOCK = threading.Lock()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v: (B, S, H, Dh) with k/v already GQA-expanded to H heads.
    Returns (B, S, H, Dh) in q's dtype. Self-attention positions 0..S-1.
    Unlike the reference wrapper nothing is transposed or padded: the
    kernel reads (B, S, H, Dh) in place and masks the ragged edge."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention wants q/k/v of one (B,S,H,Dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _fa.DTYPES:
        raise ValueError(f"flash_attention takes one dtype of {_fa.DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.shape[-1] not in _fa.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes Dh in "
                         f"{_fa.HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    out = _fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     s_valid=q.shape[1])
    with _COUNT_LOCK:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
