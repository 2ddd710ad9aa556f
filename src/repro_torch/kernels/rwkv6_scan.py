"""Launcher of the hand-written CUDA WKV6 kernels.

Counterpart of ``repro/kernels/rwkv6_scan.py`` (the Pallas TPU kernel
``wkv6_kernel``). The kernels are in ``csrc/rwkv6_scan.cu``: T up to
``DECODE_MAX_T`` runs the decode kernel (a grid over batch, head and
32-column group of the state), longer T the chunked kernel (one block per
batch and head, the state in register tiles, r/k/v/w by TMA through a
ring of ``CHUNK``-step stages); the C entry chooses from T, and each call
is one launch. This module binds that entry with ctypes and launches it
on PyTorch's current stream. It is reached through ``kernels/ops.wkv6``,
which validates the inputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_SIZES = (16, 32, 64)
# time steps per staged chunk of the chunked kernel, and the longest T
# that the decode kernel takes (csrc/rwkv6_scan.cu's CH and DECODE_MAX_T)
CHUNK = 16
DECODE_MAX_T = 4
# the tensor maps and the 128-bit loads need 16-byte-aligned r/k/v/w/s0
ALIGN = 16

_bound = None
_OWN_ERRORS = {1001: "cuTensorMapEncodeTiled not found in the driver",
               1002: "the driver refused a TMA tensor map"}


def _lib():
    return build.load("rwkv6_scan")


def _entry():
    global _bound
    if _bound is None:
        fn = _lib().wkv6_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def kernel_constants() -> tuple[int, int]:
    """(chunk, decode_max_t) as the compiled kernel has them (builds the
    library: needs nvcc)."""
    chunk, dmax = ctypes.c_int(), ctypes.c_int()
    _lib().wkv6_constants(ctypes.byref(chunk), ctypes.byref(dmax))
    return chunk.value, dmax.value


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r/k/v/w: contiguous, ``ALIGN``-aligned CUDA (B, T, H, hs) f32, hs in
    ``HEAD_SIZES``; u: contiguous (H, hs) f32; s0: contiguous, aligned
    (B, H, hs, hs) f32 (checked by the caller). Returns (y (B, T, H, hs),
    s_final (B, H, hs, hs))."""
    b, t, h, hs = r.shape
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                       y.data_ptr(), s_final.data_ptr(), b, t, h, hs, stream)
    if err != 0:
        what = _OWN_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"wkv6 kernel launch failed: {what} at "
                           f"B={b} T={t} H={h} hs={hs}")
    return y, s_final
