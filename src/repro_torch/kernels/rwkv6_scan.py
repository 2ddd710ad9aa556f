"""Launcher of the hand-written CUDA WKV6 kernel.

Counterpart of ``repro/kernels/rwkv6_scan.py`` (the Pallas TPU kernel
``wkv6_kernel``). The kernel itself is ``csrc/rwkv6_scan.cu``; this
module binds its C entry with ctypes and launches it on PyTorch's
current stream. It is reached through ``kernels/ops.wkv6``, which
validates the inputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_SIZES = (16, 32, 64)

_bound = None


def _entry():
    global _bound
    if _bound is None:
        fn = build.load("rwkv6_scan").wkv6_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r/k/v/w: contiguous CUDA (B, T, H, hs) f32, hs in ``HEAD_SIZES``;
    u: contiguous (H, hs) f32; s0: contiguous (B, H, hs, hs) f32 (checked
    by the caller). Returns (y (B, T, H, hs), s_final (B, H, hs, hs))."""
    b, t, h, hs = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                       y.data_ptr(), s_final.data_ptr(), b, t, h, hs, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err} at "
                           f"B={b} T={t} H={h} hs={hs}")
    return y, s_final
