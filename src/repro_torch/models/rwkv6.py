"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mix with
data-dependent decay + squared-ReLU channel mix.

Counterpart of ``repro/models/rwkv6.py``. Recurrence (per head, head
size hs), state S in R^{hs x hs}::

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

with w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1). Every serving scan, in
prefill (T = S) and in decode (T = 1), goes through ``kernels.ops.wkv6``
— the hand-written CUDA kernel on a card, the plain :func:`_wkv_scan` on
CPU tensors — where the reference runs its ``lax.scan`` and names the
Pallas kernel as the production path. Train mode runs the plain
``kernels.ref.wkv6``, which autograd differentiates (the kernel has no
backward, nor has the reference's), and recomputes each layer in the
backward (``common.remat``, the reference's ``jax.checkpoint``): the
step loop keeps a state per step for the backward, so without it every
layer's T-step graph would live at once. ``scan`` replaces the scan of
either mode with another function of the same signature
(``kernels.ref.wkv6`` holds the kernel against the plain path). A
Python loop over the layers replaces ``scan_or_unroll``.

``shard_fn`` (``layers.ShardFn``) pins the reference's seven sites: r,
k, v and w at ``("batch", None, "heads", None)`` before the scan, the
residual at ``("batch", "seq", None)`` after the time mix and after the
channel mix, and the channel mix's hidden ``kk`` at ``("batch", None,
"mlp")``. Over a ``DeviceMesh`` (DTensor activations) the scan of every
mode runs on each peer's local (batch, heads) blocks
(:func:`scan_blocks`, an explicit ``local_map``): the kernel's wrapper
takes plain tensors, and train mode's plain step loop runs there on
plain tensors too, where on DTensors each of its T steps would pay
DTensor's dispatch.

Casts follow the reference exactly, since in bf16 another order of
casts is another model: the decay log ``w0 + lora`` is summed in f32
from a compute-dtype product, r/k/v are cast to f32 before the scan,
the WKV state stays f32 while ``tm_x``/``cm_x`` are in the compute dtype,
and ``ln_x`` uses ``eps=1e-5`` (the other layer norms 1e-6).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.common import ParamSpec, remat, stacked, tree_map
from repro_torch.models.layers import (ShardFn, apply_norm, as_dtensor,
                                       even_reshape, kept_shards, matmul,
                                       no_shard, norm_specs, whole)

N_MIX = 5  # r, k, v, g, w token-shift interpolations


def rwkv_block_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lw, lm = cfg.rwkv_decay_lora, cfg.rwkv_mix_lora
    return {
        "ln1": norm_specs(d, "layernorm"),
        "ln2": norm_specs(d, "layernorm"),
        "tm": {
            "mu_x": ParamSpec((d,), ("embed",), init="zeros"),
            "mu": ParamSpec((N_MIX, d), (None, "embed"), init="zeros"),
            "mix_a": ParamSpec((d, N_MIX * lm), ("embed", None)),
            "mix_b": ParamSpec((N_MIX, lm, d), (None, None, "embed")),
            "w0": ParamSpec((d,), ("embed",), init="zeros"),
            "w_a": ParamSpec((d, lw), ("embed", None)),
            "w_b": ParamSpec((lw, d), (None, "embed")),
            "u": ParamSpec((d,), ("embed",), init="zeros"),
            "wr": ParamSpec((d, d), ("embed", "heads")),
            "wk": ParamSpec((d, d), ("embed", "heads")),
            "wv": ParamSpec((d, d), ("embed", "heads")),
            "wg": ParamSpec((d, d), ("embed", "heads")),
            "wo": ParamSpec((d, d), ("heads", "embed")),
            "ln_x": norm_specs(d, "layernorm"),
        },
        "cm": {
            "mu_k": ParamSpec((d,), ("embed",), init="zeros"),
            "mu_r": ParamSpec((d,), ("embed",), init="zeros"),
            "wk": ParamSpec((d, f), ("embed", "mlp")),
            "wv": ParamSpec((f, d), ("mlp", "embed")),
            "wr": ParamSpec((d, d), ("embed", "heads")),
        },
    }


def rwkv_stack_specs(cfg: ModelConfig) -> dict:
    return tree_map(lambda s: stacked(s, cfg.num_layers),
                    rwkv_block_specs(cfg))


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` (B,1,D) for position -1."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Data-dependent interpolations for the 5 branches: (B,T,5,D)."""
    dt = x.dtype
    base = x + xx * p["mu_x"].to(dt)
    lo = torch.tanh(matmul(base, p["mix_a"].to(dt)))
    lo = even_reshape(lo, (*lo.shape[:-1], N_MIX, lo.shape[-1] // N_MIX))
    delta = torch.einsum("btnm,nmd->btnd", lo, p["mix_b"].to(dt))
    mix = p["mu"].to(dt) + delta
    return x[:, :, None, :] + xx[:, :, None, :] * mix


def _wkv_scan(r, k, v, w, u, state):
    """The plain step loop. r,k,v: (B,T,H,hs); w: (B,T,H,hs) decay in
    (0,1); u: (H,hs); state: (B,H,hs,hs). Returns (out (B,T,H,hs),
    new_state). f32 math."""
    s = state
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,hs)
        kv = kt[..., :, None] * vt[..., None, :]             # (B,H,hs,hs)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def scan_blocks(scan: Callable, r, k, v, w, u, state):
    """``scan(r, k, v, w, u, state)`` (the :func:`_wkv_scan` signature),
    on each peer's local blocks when r is a DTensor, through an explicit
    ``local_map``: r/k/v/w (B, T, H, hs) keep the batch and heads
    sharding the ``("batch", None, "heads", None)`` pin gave them (every
    other dim gathered, pending sums reduced), ``u`` (H, hs) is split
    as the heads are, and the state (B, H, hs, hs) as the batch and the
    heads are: wherever it arrives (a decode cache at
    ``cache_shardings`` splits the state's key dim over ``model``, a
    prefill's zeros are plain), it is redistributed to those blocks, and
    the new state comes back at them. The scan gets plain, contiguous
    tensors (the kernel's wrapper reads ``data_ptr()``)."""
    if not isinstance(r, DTensor):
        return scan(r, k, v, w, u, state)
    mesh = r.device_mesh
    x_pl = kept_shards(r, (0, 2))
    u_pl = [Shard(0) if p == Shard(2) else Replicate() for p in x_pl]
    s_pl = [Shard(1) if p == Shard(2) else p for p in x_pl]
    # u's gradient (train mode): each peer's rows add up over the batch's
    # mesh dims, its heads block stays its own
    ug_pl = [Partial() if p == Shard(0) else q for p, q in zip(x_pl, u_pl)]

    def local(*ts):
        return scan(*(t.contiguous() for t in ts))

    return local_map(local, out_placements=(x_pl, s_pl),
                     in_placements=(x_pl,) * 4 + (u_pl, s_pl),
                     in_grad_placements=(x_pl,) * 4 + (ug_pl, s_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        r, k, v, w, as_dtensor(u, mesh), as_dtensor(state, mesh))


def apply_rwkv_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     state: dict, scan: Callable,
                     shard_fn: ShardFn = no_shard):
    """state: {"wkv": (B,H,hs,hs) f32, "tm_x": (B,1,D), "cm_x": (B,1,D)}.
    Any T (prefill: T=S; decode: T=1). Returns (x, new_state)."""
    b, t, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    dt = x.dtype
    tm = p["tm"]

    # ---- time mix ----
    xin = apply_norm(p["ln1"], x, "layernorm")
    xx = _shift(xin, state["tm_x"].to(dt)) - xin
    xb = _ddlerp(tm, xin, xx)                              # (B,T,5,D)
    xr, xk, xv, xg, xw = whole(xb, 2).unbind(dim=2)
    r = matmul(xr, tm["wr"].to(dt))
    k = matmul(xk, tm["wk"].to(dt))
    v = matmul(xv, tm["wv"].to(dt))
    g = F.silu(matmul(xg, tm["wg"].to(dt)))
    wl = torch.tanh(matmul(xw, tm["w_a"].to(dt)))
    wlog = tm["w0"].float() + matmul(wl, tm["w_b"].to(dt)).float()
    w = torch.exp(-torch.exp(wlog))                        # (B,T,D) in (0,1)

    shp = (b, t, h, hs)
    heads = lambda a: shard_fn(even_reshape(a, shp), ("batch", None,
                                                      "heads", None))
    u = even_reshape(tm["u"].float(), (h, hs))
    y, new_wkv = scan_blocks(scan, heads(r.float()), heads(k.float()),
                             heads(v.float()), heads(w), u,
                             state["wkv"].float())

    y = apply_norm(tm["ln_x"], even_reshape(y, (b, t, d)).to(dt),
                   "layernorm", eps=1e-5)
    x = x + matmul(y * g, tm["wo"].to(dt))
    x = shard_fn(x, ("batch", "seq", None))
    new_tm_x = xin[:, -1:, :]

    # ---- channel mix ----
    cm = p["cm"]
    xin = apply_norm(p["ln2"], x, "layernorm")
    xx = _shift(xin, state["cm_x"].to(dt)) - xin
    kk = matmul(xin + xx * cm["mu_k"].to(dt), cm["wk"].to(dt))
    kk = shard_fn(torch.square(F.relu(kk)), ("batch", None, "mlp"))
    vv = matmul(kk, cm["wv"].to(dt))
    rr = torch.sigmoid(matmul(xin + xx * cm["mu_r"].to(dt),
                              cm["wr"].to(dt)))
    x = shard_fn(x + rr * vv, ("batch", "seq", None))
    return x, {"wkv": new_wkv, "tm_x": new_tm_x, "cm_x": xin[:, -1:, :]}


def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    """Zero decode state: {"wkv": (L,B,H,hs,hs) f32, "tm_x"/"cm_x":
    (L,B,1,D) in ``dtype``}."""
    d, hs, L = cfg.d_model, cfg.rwkv_head_size, cfg.num_layers
    return {
        "wkv": torch.zeros((L, batch, d // hs, hs, hs), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((L, batch, 1, d), dtype=dtype, device=device),
        "cm_x": torch.zeros((L, batch, 1, d), dtype=dtype, device=device),
    }


def init_state_specs(cfg: ModelConfig, batch: int, dtype) -> dict:
    """The layout of :func:`init_state` as ``meta`` tensors (``dtype``: a
    config dtype name)."""
    return init_state(cfg, batch, torch_dtype(dtype), torch.device("meta"))


def apply_rwkv_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     mode: str, state: Optional[dict] = None,
                     scan: Optional[Callable] = None,
                     shard_fn: ShardFn = no_shard):
    """Run the blocks over the stacked params, threading each layer's
    state (zeros when ``state`` is None, as for a prefill and in train
    mode). ``mode`` is train, prefill or decode: train defaults ``scan``
    to the plain ``kernels.ref.wkv6`` and recomputes each layer in the
    backward, the others default it to the kernel. ``shard_fn`` pins
    each block's sites (module docstring). Returns (x, new_state) with
    the layout of :func:`init_state`."""
    scan = ops.train_or_kernel(mode, scan, ref.wkv6, ops.wkv6)
    if state is None:
        state = init_state(cfg, x.shape[0], x.dtype, x.device)
    train = mode == "train"
    new = []
    for layer in range(cfg.num_layers):
        p = tree_map(lambda a: a[layer], params)
        st = {k: v[layer] for k, v in state.items()}
        if train:
            x, ns = remat(apply_rwkv_block, p, x, cfg, state=st, scan=scan,
                          shard_fn=shard_fn)
        else:
            x, ns = apply_rwkv_block(p, x, cfg, state=st, scan=scan,
                                     shard_fn=shard_fn)
        new.append(ns)
    return x, {k: torch.stack([ns[k] for ns in new]) for k in state}
