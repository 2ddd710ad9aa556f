"""Launcher of the hand-written CUDA flash-attention kernel.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel ``flash_attention_kernel``). The kernel itself is
``csrc/flash_attention.cu``; this module binds its C entry with ctypes
and launches it on PyTorch's current stream. It is reached through
``kernels/ops.flash_attention``, which validates the inputs and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool, window: int,
                           s_valid: int) -> torch.Tensor:
    """q/k/v: contiguous CUDA (B, S, H, Dh), one dtype of ``DTYPES``,
    Dh in ``HEAD_DIMS`` (checked by the caller). Returns (B, S, H, Dh) in
    q's dtype. Keys at positions >= ``s_valid`` are masked."""
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, s, h, dh,
                       int(q.dtype == torch.bfloat16), int(causal),
                       int(window), int(s_valid), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at B={b} S={s} H={h} Dh={dh} "
                           f"{q.dtype}")
    return out
