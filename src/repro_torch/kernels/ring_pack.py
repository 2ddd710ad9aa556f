"""Launchers of the hand-written CUDA ring-pack and unpack kernels.

Counterpart of ``repro/kernels/ring_pack.py`` (the Pallas TPU kernels
``pack_slices_kernel`` and ``unpack_slices_kernel``). The kernels are
``csrc/ring_pack.cu``; this module binds their C entries with ctypes and
launches them on PyTorch's current stream. They are reached through
``kernels/ops.pack_slices`` / ``ops.unpack_slices``, which validate the
inputs and count launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_bound: dict = {}


def _entry(name: str, argtypes: list):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(build.load("ring_pack"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def pack_slices_kernel(flat: torch.Tensor, ef: Optional[torch.Tensor],
                       n_slices: int, slice_elems: int,
                       wire_dtype: torch.dtype, with_ef: bool):
    """flat: contiguous CUDA (n_slices * slice_elems,) f32; ef: None or a
    contiguous (n_slices, slice_elems) f32 on the same card (checked by
    the caller). Returns (wire (n, S) of ``wire_dtype``, new_ef (n, S) f32
    or None without EF)."""
    shape = (n_slices, slice_elems)
    wire = torch.empty(shape, dtype=wire_dtype, device=flat.device)
    new_ef = torch.empty(shape, dtype=torch.float32, device=flat.device) \
        if with_ef else None
    fn = _entry("ring_pack", [ctypes.c_void_p] * 4
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = fn(_ptr(flat), _ptr(ef if with_ef else None), _ptr(wire),
                 _ptr(new_ef), flat.numel(),
                 int(wire_dtype == torch.bfloat16), int(with_ef), stream)
    if err != 0:
        raise RuntimeError(f"ring_pack kernel launch failed: CUDA error "
                           f"{err} at n={n_slices} S={slice_elems} "
                           f"wire={wire_dtype} with_ef={with_ef}")
    return wire, new_ef


def unpack_slices_kernel(wire: torch.Tensor) -> torch.Tensor:
    """wire: contiguous CUDA (n, S) bf16 or f32. Returns (n * S,) f32."""
    out = torch.empty(wire.numel(), dtype=torch.float32, device=wire.device)
    fn = _entry("ring_unpack", [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p])
    with torch.cuda.device(wire.device):
        stream = torch.cuda.current_stream(wire.device).cuda_stream
        err = fn(_ptr(wire), _ptr(out), wire.numel(),
                 int(wire.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ring_unpack kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(wire.shape)} "
                           f"{wire.dtype}")
    return out
