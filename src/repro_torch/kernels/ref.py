"""Plain PyTorch versions of the port's kernels, signature-identical to
``kernels/ops.py``.

Counterpart of ``repro/kernels/ref.py``. ``ops`` hands a CPU tensor to
these; ``chip_smoke.py`` and the card tests hold each CUDA kernel
against them on the same inputs.

The two scans also have a log-depth form (:func:`wkv6_log_depth`,
:func:`rglru_log_depth`): the same linear recurrence as an inclusive
prefix scan (Hillis-Steele, the form of the reference's
``lax.associative_scan``) in O(log T) ops of O(T) size, where the step
loops issue O(T) small ops. Only the dry run uses them
(``launch/dryrun``): under ``FakeTensorMode`` each op costs about a
millisecond of host time whatever its size, and a 32k-step loop would
take most of an hour. Their values differ from the loops' in rounding
only (the sums run in another order).
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


# -- log-depth forms of the two scans ----------------------------------------


def _prefix_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` from h = 0
    along dim 1 (``a`` broadcasts against ``b``): log2(T) doubling
    steps, each folding in the partial result ``d`` steps back."""
    t, d = b.shape[1], 1
    while d < t:
        pad = lambda x, fill: torch.cat([torch.full_like(x[:, :d], fill),
                                         x[:, :-d]], dim=1)
        b = a * pad(b, 0.0) + b
        a = a * pad(a, 1.0)
        d *= 2
    return b


def wkv6_log_depth(r, k, v, w, u, s0):
    """:func:`wkv6` as a prefix scan over the states (every step's state
    materialized, (B, T, H, hs, hs))."""
    r, k, v, w, u, s0 = (x.float() for x in (r, k, v, w, u, s0))
    kv = k[..., :, None] * v[..., None, :]                # (B,T,H,hs,hs)
    a = w[..., :, None]
    first = kv[:, :1] + a[:, :1] * s0[:, None]
    s = _prefix_scan(a, torch.cat([first, kv[:, 1:]], dim=1))
    prev = torch.cat([s0[:, None], s[:, :-1]], dim=1)      # S_{t-1}
    y = torch.einsum("bthi,bthij->bthj", r, prev + u[:, :, None] * kv)
    return y, s[:, -1]


def rglru_log_depth(a, b, h0):
    """:func:`rglru` as a prefix scan (h0 folded into b_1, as the
    reference folds it)."""
    a, b, h0 = a.float(), b.float(), h0.float()
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    hs = _prefix_scan(a, b)
    return hs, hs[:, -1]
