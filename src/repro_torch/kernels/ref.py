"""Plain PyTorch versions of the port's kernels, signature-identical to
``kernels/ops.py``.

Counterpart of ``repro/kernels/ref.py``. ``ops`` hands a CPU tensor to
these; ``chip_smoke.py`` and the card tests hold each CUDA kernel
against them on the same inputs.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as att

WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# -- ring pack ---------------------------------------------------------------


def pack_slices(flat: torch.Tensor, ef, *, n_slices: int, slice_elems: int,
                wire_dtype: str = "bfloat16", with_ef: bool = True):
    """(add EF, cast to the wire dtype, capture the residual) over the
    (n_slices, slice_elems) view of ``flat``. Returns (wire, new_ef), or
    (wire, None) without EF. ``ef=None`` with EF on means a zero
    residual (added, as in the reference, so -0.0 becomes +0.0)."""
    x = flat.reshape(n_slices, slice_elems).float()
    wdt = WIRE_DTYPES[wire_dtype]
    if not with_ef:
        return x.to(wdt), None
    if ef is None:
        ef = torch.zeros_like(x)
    y = x + ef
    wire = y.to(wdt)
    return wire, y - wire.float()


def unpack_slices(wire: torch.Tensor, out_dtype: str = "float32"):
    """(n, S) wire -> (n * S,) of ``out_dtype``."""
    return wire.to(WIRE_DTYPES[out_dtype]).reshape(-1)


# -- flash attention ---------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, KV, Dh) with H % KV == 0, expanded
    here to H heads when KV < H; self-attention positions 0..S-1."""
    h = q.shape[2]
    k, v = att.expand_kv(k, h), att.expand_kv(v, h)
    pos = torch.arange(q.shape[1], device=q.device)
    return att.attend_direct(q, k, v, pos, pos, causal=causal, window=window)


# -- WKV6 --------------------------------------------------------------------


def wkv6(r, k, v, w, u, s0):
    """The model's own step loop, ``models.rwkv6._wkv_scan``, in f32."""
    from repro_torch.models.rwkv6 import _wkv_scan
    f32 = lambda x: x.float()
    return _wkv_scan(f32(r), f32(k), f32(v), f32(w), f32(u), f32(s0))


# -- RG-LRU ------------------------------------------------------------------


def rglru(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` one step at a time, in f32."""
    a, b, h = a.float(), b.float(), h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h
