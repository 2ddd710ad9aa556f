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
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import ring_pack as _rp
from repro_torch.kernels import rwkv6_scan as _wk

_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def _no_autograd(name: str, *tensors) -> None:
    """A CUDA kernel of the port has no backward: under autograd with an
    input that requires grad its output would carry no gradient, so the
    wrapper raises instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, so its output would "
            "carry no gradient; train through the plain version (as train "
            "mode does) or call the kernel under torch.no_grad()")


MODES = ("train", "prefill", "decode")


def train_or_kernel(mode: str, given: Optional[Callable], plain: Callable,
                    kernel: Callable) -> Callable:
    """The function a model stack runs in ``mode``: ``given`` when the
    caller passed one, else ``plain`` in train mode (autograd
    differentiates it; the kernels have no backward) and the ``kernel``
    wrapper in prefill and decode. An unknown mode raises. Every stack
    picks through here, so no train mode reaches a kernel by default,
    not even where the CPU would hide it (a wrapper sends a CPU tensor
    to its plain version before it checks autograd)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    return given or (plain if mode == "train" else kernel)


def _device_of(*tensors) -> str:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


# ---------------------------------------------------------------------------
# ring pack
# ---------------------------------------------------------------------------


def pack_slices(flat: torch.Tensor, ef, *, n_slices: int, slice_elems: int,
                wire_dtype: str = "bfloat16", with_ef: bool = True):
    """Fused (add EF, cast to the wire dtype, capture the residual) over
    the (n_slices, slice_elems) view of ``flat`` — see
    ``csrc/ring_pack.cu``. flat: contiguous (n_slices * slice_elems,) f32
    (``aggregation.pack`` pads it so); ef: None or contiguous
    (n_slices, slice_elems) f32. Returns (wire (n, S), new_ef (n, S) f32)
    with EF, (wire, None) without."""
    if wire_dtype not in ref.WIRE_DTYPES:
        raise ValueError(f"pack_slices: wire_dtype must be one of "
                         f"{tuple(ref.WIRE_DTYPES)}, got {wire_dtype!r}")
    if n_slices < 1 or slice_elems < 1:
        raise ValueError(f"pack_slices: n_slices and slice_elems must be "
                         f">= 1, got {n_slices}, {slice_elems}")
    if flat.dtype != torch.float32 or flat.shape != (n_slices * slice_elems,):
        raise ValueError(f"pack_slices: flat must be a ({n_slices} * "
                         f"{slice_elems},) float32 vector, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    ef = ef if with_ef else None
    if ef is not None and (ef.dtype != torch.float32
                           or ef.shape != (n_slices, slice_elems)):
        raise ValueError(f"pack_slices: ef must be ({n_slices}, "
                         f"{slice_elems}) float32, got {tuple(ef.shape)} "
                         f"{ef.dtype}")
    if _device_of(flat, ef) == "cpu":
        return ref.pack_slices(flat, ef, n_slices=n_slices,
                               slice_elems=slice_elems,
                               wire_dtype=wire_dtype, with_ef=with_ef)
    if not flat.is_contiguous() or (ef is not None
                                    and not ef.is_contiguous()):
        raise ValueError("pack_slices kernel needs contiguous flat and ef")
    out = _rp.pack_slices_kernel(flat, ef, n_slices, slice_elems,
                                 ref.WIRE_DTYPES[wire_dtype], with_ef)
    _count(pack_slices)
    return out


pack_slices.launches = 0


def unpack_slices(wire: torch.Tensor, out_dtype: str = "float32"):
    """Fused cast-from-wire-dtype + re-slice (the scattering read) — see
    ``csrc/ring_pack.cu``. wire: contiguous (n, S) bf16 or f32. Returns
    (n * S,) of ``out_dtype``; the kernel writes float32 only (the one
    dtype the unpack stage asks for)."""
    if wire.dim() != 2 or wire.dtype not in ref.WIRE_DTYPES.values():
        raise ValueError(f"unpack_slices: wire must be (n, S) bfloat16 or "
                         f"float32, got {tuple(wire.shape)} {wire.dtype}")
    if out_dtype != "float32":
        raise ValueError(f"unpack_slices: out_dtype must be 'float32', "
                         f"got {out_dtype!r}")
    if _device_of(wire) == "cpu":
        return ref.unpack_slices(wire, out_dtype)
    if not wire.is_contiguous():
        raise ValueError("unpack_slices kernel needs a contiguous wire")
    out = _rp.unpack_slices_kernel(wire)
    _count(unpack_slices)
    return out


unpack_slices.launches = 0


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, KV, Dh) with H % KV == 0, KV = H
    included: query head h reads KV head h // (H // KV), as
    ``attention.expand_kv`` lays it out, but nothing is expanded. Returns
    (B, S, H, Dh) in q's dtype. Self-attention positions 0..S-1. Unlike
    the reference wrapper nothing is transposed or padded: the kernel
    reads the tensors in place and masks the ragged edge.

    On the card bf16 runs the tensor-core kernel and f32 the exact FMA
    kernel (chosen by dtype, not a fallback: a failed launch raises).
    The bf16 kernel loads through TMA, which needs 16-byte-aligned
    bases: a misaligned view raises; nothing is copied."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes plain tensors: run it on "
                        "each peer's local blocks of a DTensor "
                        "(models/transformer.attend_blocks)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or (k.shape[0], k.shape[1], k.shape[3]) \
            != (q.shape[0], q.shape[1], q.shape[3]):
        raise ValueError(f"flash_attention wants q (B,S,H,Dh) and k/v of "
                         f"one (B,S,KV,Dh) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: H % KV must be 0, got H="
                         f"{q.shape[2]} KV={k.shape[2]}")
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
    _no_autograd("flash_attention", q, k, v)
    if q.shape[-1] not in _fa.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes Dh in "
                         f"{_fa.HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % _fa.ALIGN for t in (q, k, v)):
        raise ValueError(f"flash_attention kernel needs {_fa.ALIGN}-byte-"
                         f"aligned bf16 q/k/v (TMA), got base addresses "
                         f"{[hex(t.data_ptr()) for t in (q, k, v)]}")
    out = _fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     s_valid=q.shape[1])
    _count(flash_attention)
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor):
    """The RWKV-6 recurrence — see ``csrc/rwkv6_scan.cu``. r/k/v/w:
    (B, T, H, hs) f32 (w the decay in (0, 1)); u: (H, hs) f32; s0:
    (B, H, hs, hs) f32. Returns (y (B, T, H, hs), s_final (B, H, hs, hs)),
    f32 — ``models.rwkv6._wkv_scan``'s function. Unlike the reference
    wrapper nothing is transposed or padded: the kernel reads
    (B, T, H, hs) in place."""
    if any(isinstance(x, DTensor) for x in (r, k, v, w, u, s0)):
        raise TypeError("wkv6 takes plain tensors: run it on each peer's "
                        "local blocks of a DTensor "
                        "(models/rwkv6.scan_blocks)")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"wkv6 wants r/k/v/w of one (B,T,H,hs) shape, got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    b, t, h, hs = r.shape
    if t < 1:
        raise ValueError("wkv6 needs T >= 1")
    if u.shape != (h, hs) or s0.shape != (b, h, hs, hs):
        raise ValueError(f"wkv6 wants u ({h}, {hs}) and s0 ({b}, {h}, {hs}, "
                         f"{hs}), got {tuple(u.shape)}, {tuple(s0.shape)}")
    if any(x.dtype != torch.float32 for x in (r, k, v, w, u, s0)):
        raise ValueError("wkv6 takes float32 r/k/v/w/u/s0 (the model casts "
                         "before the scan)")
    if _device_of(r, k, v, w, u, s0) == "cpu":
        return ref.wkv6(r, k, v, w, u, s0)
    _no_autograd("wkv6", r, k, v, w, u, s0)
    if hs not in _wk.HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes hs in {_wk.HEAD_SIZES}, got "
                         f"{hs}")
    if not all(x.is_contiguous() for x in (r, k, v, w, u, s0)):
        raise ValueError("wkv6 kernel needs contiguous r/k/v/w/u/s0")
    if any(x.data_ptr() % _wk.ALIGN for x in (r, k, v, w, s0)):
        raise ValueError(f"wkv6 kernel needs {_wk.ALIGN}-byte-aligned "
                         f"r/k/v/w/s0 (TMA), got base addresses "
                         f"{[hex(x.data_ptr()) for x in (r, k, v, w, s0)]}")
    out = _wk.wkv6_kernel(r, k, v, w, u, s0)
    _count(wkv6)
    return out


wkv6.launches = 0


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The linear recurrence ``h_t = a_t * h_{t-1} + b_t`` — see
    ``csrc/rglru.cu``. a/b: (B, T, W) f32; h0: (B, W) f32. Returns
    (h_seq (B, T, W), h_final (B, W)) — the scan core of
    ``models.hybrid._rglru``. Any T and W: nothing is padded."""
    if any(isinstance(x, DTensor) for x in (a, b, h0)):
        raise TypeError("rglru takes plain tensors: run it on each peer's "
                        "local blocks of a DTensor "
                        "(models/hybrid.scan_blocks)")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru wants a/b of one (B,T,W) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[1] < 1:
        raise ValueError("rglru needs T >= 1")
    if h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru wants h0 ({a.shape[0]}, {a.shape[2]}), got "
                         f"{tuple(h0.shape)}")
    if any(x.dtype != torch.float32 for x in (a, b, h0)):
        raise ValueError("rglru takes float32 a/b/h0")
    if _device_of(a, b, h0) == "cpu":
        return ref.rglru(a, b, h0)
    _no_autograd("rglru", a, b, h0)
    if not all(x.is_contiguous() for x in (a, b, h0)):
        raise ValueError("rglru kernel needs contiguous a/b/h0")
    out = _rg.rglru_kernel(a, b, h0)
    _count(rglru)
    return out


rglru.launches = 0
