"""Launcher of the hand-written CUDA RG-LRU kernel.

Counterpart of ``repro/kernels/rglru.py`` (the Pallas TPU kernel
``rglru_kernel``). The kernel itself is ``csrc/rglru.cu``; this module
binds its C entry with ctypes and launches it on PyTorch's current
stream. It is reached through ``kernels/ops.rglru``, which validates the
inputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = build.load("rglru").rglru_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def rglru_kernel(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a/b: contiguous CUDA (B, T, W) f32; h0: contiguous (B, W) f32
    (checked by the caller). Returns (h_seq (B, T, W), h_final (B, W))."""
    bsz, t, w = a.shape
    y = torch.empty_like(a)
    h_final = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry()(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                       y.data_ptr(), h_final.data_ptr(), bsz, t, w, stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err} at "
                           f"B={bsz} T={t} W={w}")
    return y, h_final
