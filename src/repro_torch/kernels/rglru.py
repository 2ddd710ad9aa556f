"""Launcher of the hand-written CUDA RG-LRU kernel.

Counterpart of ``repro/kernels/rglru.py`` (the Pallas TPU kernel
``rglru_kernel``). The kernel itself is ``csrc/rglru.cu``: blocks of 64
channels stream (``CHUNK`` steps x 64 channels) tiles of a and b through
a 4-stage ring in shared memory. Which load path fills the ring is chosen
by the C entry from the shape, one launch either way:

* W % 4 == 0 and a, b at 16-byte-aligned addresses (recurrentgemma's
  W = 4096 and every tensor the model passes): TMA tensor maps;
* any other W (4099, 65, 7 ...) or a misaligned base: 4-byte
  ``cp.async`` copies, each thread its own channel.

This module binds that entry with ctypes and launches it on PyTorch's
current stream. It is reached through ``kernels/ops.rglru``, which
validates the inputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# time steps per staged tile (csrc/rglru.cu's CH)
CHUNK = 32

_bound = None
_OWN_ERRORS = {1001: "cuTensorMapEncodeTiled not found in the driver",
               1002: "the driver refused a TMA tensor map"}


def _lib():
    return build.load("rglru")


def _entry():
    global _bound
    if _bound is None:
        fn = _lib().rglru_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def kernel_chunk() -> int:
    """``CHUNK`` as the compiled kernel has it (builds the library)."""
    chunk = ctypes.c_int()
    _lib().rglru_constants(ctypes.byref(chunk))
    return chunk.value


def load_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """"tma" or "cp.async": the path the C entry takes for these a and b."""
    fn = _lib().rglru_uses_tma
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return "tma" if fn(a.data_ptr(), b.data_ptr(), a.shape[-1]) else \
        "cp.async"


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
        what = _OWN_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"rglru kernel launch failed: {what} at "
                           f"B={bsz} T={t} W={w}")
    return y, h_final
