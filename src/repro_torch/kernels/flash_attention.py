"""Launcher of the hand-written CUDA flash-attention kernels.

Counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel ``flash_attention_kernel``). The kernels are in
``csrc/flash_attention.cu``: bf16 runs the tensor-core kernel (``wgmma``
products, K/V tiles by TMA), f32 the exact FMA kernel; the C entry
chooses by dtype. This module binds that entry with ctypes and launches
it on PyTorch's current stream. It is reached through
``kernels/ops.flash_attention``, which validates the inputs and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# the bf16 kernel's tensor maps need 16-byte-aligned base addresses
ALIGN = 16

_bound = None
_OWN_ERRORS = {1001: "cuTensorMapEncodeTiled not found in the driver",
               1002: "the driver refused a TMA tensor map"}


def _entry():
    global _bound
    if _bound is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool, window: int,
                           s_valid: int) -> torch.Tensor:
    """q: contiguous CUDA (B, S, H, Dh); k/v: contiguous (B, S, KV, Dh)
    with H % KV == 0; one dtype of ``DTYPES``, Dh in ``HEAD_DIMS``, bf16
    bases ``ALIGN``-byte aligned (all checked by the caller). Returns
    (B, S, H, Dh) in q's dtype. Keys at positions >= ``s_valid`` are
    masked."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, s, h, kv, dh,
                       int(q.dtype == torch.bfloat16), int(causal),
                       int(window), int(s_valid), stream)
    if err != 0:
        what = _OWN_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention kernel launch failed: {what} "
                           f"at B={b} S={s} H={h} KV={kv} Dh={dh} "
                           f"{q.dtype}")
    return out
