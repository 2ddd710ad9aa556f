"""RecurrentGemma-style hybrid stack (arXiv:2402.19427): RG-LRU recurrent
blocks + local (windowed) attention, cycled by ``cfg.block_pattern``.
Every temporal block is followed by a gated MLP.

Counterpart of ``repro/models/hybrid.py``. RG-LRU::

    r_t = sigmoid(Wa y_t + ba); i_t = sigmoid(Wx y_t + bx)
    a_t = exp(-c * softplus(Lambda) * r_t)           (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

A multi-step scan (prefill) goes through ``kernels.ops.rglru`` — the
hand-written CUDA kernel on a card, its plain step loop on CPU tensors —
where the reference runs ``lax.associative_scan`` and names the Pallas
kernel as the fused production path; a decode step (T = 1) is the
one-line update, as in the reference. Local-attention prefill runs the
flash kernel through ``transformer.apply_block`` with
``window=cfg.local_window``. Train mode launches neither kernel (they
have no backward, nor have the reference's): the scan is the plain
``kernels.ref.rglru`` and the attention the plain
``attention.attend_chunked``, which autograd differentiates; each whole
group is recomputed in the backward (``common.remat``, the reference's
``jax.checkpoint`` of its group body), and no cache is returned.
``attend`` and ``scan`` replace the two of either mode with functions of
the same signatures (the plain versions hold the kernels against the
plain path).

``shard_fn`` (``layers.ShardFn``) pins the reference's sites: the
recurrent branch ``y`` at ``("batch", None, "lru")`` before the causal
conv, the residual at ``("batch", "seq", None)`` after the recurrence
and after the MLP, and the MLP's own site; the local-attention blocks
take it through ``transformer.apply_block``. Over a ``DeviceMesh``
(DTensor activations) a multi-step RG-LRU scan runs on each peer's
local (batch, lru) blocks (:func:`scan_blocks`, an explicit
``local_map``), the kernel's in prefill and train mode's plain loop
alike, and the local-attention prefill runs flash on local blocks
(``transformer.attend_blocks``: recurrentgemma's one KV head read by
every local query head); the one-step decode update stays elementwise
on DTensors.

Parameters and caches: the pattern's blocks are stacked over the
``n_groups`` whole groups under ``groups`` (leading dim n_groups, then
batch), and the remaining layers are unstacked ``tail<i>_<kind>``
entries (leading dim batch). A Python loop over groups replaces
``scan_or_unroll``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.compat import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec, remat, stacked, tree_map
from repro_torch.models.layers import (ShardFn, apply_mlp, apply_norm,
                                       as_dtensor, even_reshape, kept_shards,
                                       matmul, mlp_specs, no_shard,
                                       norm_specs)

RGLRU_C = 8.0


def _lru_blocks(cfg: ModelConfig) -> tuple[int, int]:
    lw = cfg.lru_width or cfg.d_model
    nb = max(1, cfg.num_heads)
    if lw % nb:
        raise ValueError(f"lru_width {lw} is not a multiple of the {nb} "
                         "gate blocks")
    return nb, lw // nb


def recurrent_block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    lw = cfg.lru_width or cfg.d_model
    nb, bs = _lru_blocks(cfg)
    ds = tfm.depth_scale(cfg)
    return {
        "ln1": norm_specs(d, cfg.norm_kind),
        "ln2": norm_specs(d, cfg.norm_kind),
        "w_in": ParamSpec((d, lw), ("embed", "lru")),
        "w_gate": ParamSpec((d, lw), ("embed", "lru")),
        "conv_w": ParamSpec((cfg.conv1d_width, lw), (None, "lru")),
        "conv_b": ParamSpec((lw,), ("lru",), init="zeros"),
        "wa": ParamSpec((nb, bs, bs), ("lru_blocks", None, None)),
        "ba": ParamSpec((lw,), ("lru",), init="zeros"),
        "wx": ParamSpec((nb, bs, bs), ("lru_blocks", None, None)),
        "bx": ParamSpec((lw,), ("lru",), init="zeros"),
        "lam": ParamSpec((lw,), ("lru",), init="ones"),
        "w_out": ParamSpec((lw, d), ("lru", "embed"), scale=ds),
        "mlp": mlp_specs(d, cfg.d_ff, cfg.mlp_kind, ds),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   prev: torch.Tensor):
    """Depthwise causal conv. x: (B,T,C); w: (cw,C); prev: (B,cw-1,C)
    state in x's dtype. Returns (y, new_prev)."""
    cw, t = w.shape[0], x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    y = b.to(x.dtype)[None, None, :] + sum(
        xp[:, i:i + t] * w[i].to(x.dtype) for i in range(cw))
    return y, xp[:, -(cw - 1):, :]


def scan_blocks(scan: Callable, a, b, h0, like=None):
    """``scan(a, b, h0)`` (``ops.rglru``'s signature) on plain,
    contiguous tensors. Over a mesh (``like``, the DTensor whose batch
    and lru split the scan keeps: the pinned ``y``) it runs on each
    peer's local blocks through an explicit ``local_map``: a/b (B, T,
    lru) and h0 (B, lru) split over the batch and lru as ``like`` is
    (every other dim gathered, pending sums reduced; a prefill's plain
    zero h0 placed there), and the new h_seq and h_last come back at
    those blocks."""
    if like is None:
        return scan(a.contiguous(), b.contiguous(), h0.contiguous())
    mesh = like.device_mesh
    x_pl = kept_shards(like, (0, 2))
    h_pl = [Shard(1) if p == Shard(2) else p for p in x_pl]

    def local(*ts):
        return scan(*(t.contiguous() for t in ts))

    return local_map(local, out_placements=(x_pl, h_pl),
                     in_placements=(x_pl, x_pl, h_pl), device_mesh=mesh,
                     redistribute_inputs=True)(a, b, as_dtensor(h0, mesh))


def _rglru(y: torch.Tensor, p: dict, h0: torch.Tensor, nb: int, bs: int,
           scan: Callable):
    """y: (B,T,lru) f32; h0: (B,lru) f32. Returns (h_seq (B,T,lru),
    h_last)."""
    b, t, lw = y.shape
    yb = even_reshape(y, (b, t, nb, bs))
    gate = lambda wk, bk: torch.sigmoid(even_reshape(
        torch.einsum("btni,nij->btnj", yb, p[wk].float()), (b, t, lw))
        + p[bk].float())
    r, i = gate("wa", "ba"), gate("wx", "bx")
    a = torch.exp(-RGLRU_C * F.softplus(p["lam"].float()) * r)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i * y)
    if t == 1:
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None], h
    # the reference folds h0 into b_1 before its associative scan; the
    # kernel takes h0 itself: h_1 = a_1 h0 + b_1 either way
    return scan_blocks(scan, a, gated, h0,
                       y if isinstance(y, DTensor) else None)


def apply_recurrent_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                          state: dict, scan: Callable,
                          shard_fn: ShardFn = no_shard):
    """state: {"h": (B,lru) f32, "conv": (B,cw-1,lru)}. Returns
    (x, new_state)."""
    nb, bs = _lru_blocks(cfg)
    dt = x.dtype
    xin = apply_norm(p["ln1"], x, cfg.norm_kind)
    y = matmul(xin, p["w_in"].to(dt))
    gate = matmul(xin, p["w_gate"].to(dt))
    y = shard_fn(y, ("batch", None, "lru"))
    y, new_conv = _causal_conv1d(y, p["conv_w"], p["conv_b"], state["conv"])
    hs, h_last = _rglru(y.float(), p, state["h"].float(), nb, bs, scan)
    # jax.nn.gelu's default is the tanh approximation
    out = hs.to(dt) * F.gelu(gate, approximate="tanh")
    x = shard_fn(x + matmul(out, p["w_out"].to(dt)), ("batch", "seq", None))
    x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm_kind),
                      cfg.mlp_kind, shard_fn)
    return shard_fn(x, ("batch", "seq", None)), {"h": h_last,
                                                 "conv": new_conv}


# ---------------------------------------------------------------------------
# Pattern stack: groups of len(block_pattern), then the unrolled tail
# ---------------------------------------------------------------------------


def _group_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    tail = tuple(pat[i % len(pat)]
                 for i in range(n_groups * len(pat), cfg.num_layers))
    return n_groups, tail


def _one_specs(cfg: ModelConfig, kind: str) -> dict:
    return recurrent_block_specs(cfg) if kind == "rglru" \
        else tfm.block_specs(cfg)


def hybrid_stack_specs(cfg: ModelConfig) -> dict:
    n_groups, tail = _group_layout(cfg)
    group = {f"b{i}_{k}": _one_specs(cfg, k)
             for i, k in enumerate(cfg.block_pattern)}
    specs = {"groups": tree_map(lambda s: stacked(s, n_groups), group)}
    for i, k in enumerate(tail):
        specs[f"tail{i}_{k}"] = _one_specs(cfg, k)
    return specs


def _cache_entry(cfg: ModelConfig, kind: str, lead: tuple,
                 dtype: torch.dtype, device: torch.device) -> dict:
    """Zero decode state of one block, with leading dims ``lead``."""
    z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
    if kind == "rglru":
        lw = cfg.lru_width or cfg.d_model
        return {"h": z((lw,), torch.float32),
                "conv": z((cfg.conv1d_width - 1, lw), dtype)}
    kv = (cfg.local_window, cfg.num_kv_heads, cfg.head_dim)
    return {"k": z(kv, dtype), "v": z(kv, dtype)}


def init_hybrid_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device: torch.device) -> dict:
    """{"groups": {b<i>_<kind>: leaves (n_groups, B, ...)},
    "tail<i>_<kind>": leaves (B, ...)}; local-attention pages are rolling
    (B, local_window, KV, Dh)."""
    n_groups, tail = _group_layout(cfg)
    out = {"groups": {f"b{i}_{k}": _cache_entry(cfg, k, (n_groups, batch),
                                                dtype, device)
                      for i, k in enumerate(cfg.block_pattern)}}
    for i, k in enumerate(tail):
        out[f"tail{i}_{k}"] = _cache_entry(cfg, k, (batch,), dtype, device)
    return out


def hybrid_cache_specs(cfg: ModelConfig, batch: int, dtype) -> dict:
    """The layout of :func:`init_hybrid_cache` as ``meta`` tensors
    (``dtype``: a config dtype name)."""
    return init_hybrid_cache(cfg, batch, torch_dtype(dtype),
                             torch.device("meta"))


def _apply_kind(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                mode: str, cache: Optional[dict], pos, attend, scan,
                shard_fn: ShardFn = no_shard):
    if kind == "rglru":
        if cache is None:
            cache = _cache_entry(cfg, kind, (x.shape[0],), x.dtype, x.device)
        return apply_recurrent_block(p, x, cfg, state=cache, scan=scan,
                                     shard_fn=shard_fn)
    x, nk, nv, _ = tfm.apply_block(
        p, x, cfg, mode=mode, window=cfg.local_window, attend=attend,
        cache_k=cache["k"] if cache else None,
        cache_v=cache["v"] if cache else None, pos=pos, shard_fn=shard_fn)
    # prefill pages arrive in the rolling layout (apply_block)
    return x, {"k": nk, "v": nv}


def _apply_group(pg: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 cache: Optional[dict], **kw):
    """One group of ``block_pattern``: (x, {b<i>_<kind>: new state})."""
    new = {}
    for i, kind in enumerate(cfg.block_pattern):
        key = f"b{i}_{kind}"
        x, new[key] = _apply_kind(pg[key], x, cfg, kind,
                                  cache=cache.get(key) if cache else None,
                                  **kw)
    return x, new


def _train_group(pg: dict, x: torch.Tensor, cfg: ModelConfig,
                 **kw) -> torch.Tensor:
    return _apply_group(pg, x, cfg, cache=None, mode="train", pos=None,
                        **kw)[0]


def apply_hybrid_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                       mode: str, cache: Optional[dict] = None,
                       pos: Optional[torch.Tensor] = None,
                       attend: Optional[Callable] = None,
                       scan: Optional[Callable] = None,
                       shard_fn: ShardFn = no_shard):
    """Train (no cache; each group recomputed in the backward), prefill
    (``cache`` None: zero recurrent states) or decode (one token against
    ``cache``). ``shard_fn`` pins every block's sites (module
    docstring). Returns (x, new_cache) in the layout of
    :func:`init_hybrid_cache`; the cache is None in train mode."""
    attend = ops.train_or_kernel(mode, attend, att.attend_chunked,
                                 ops.flash_attention)
    scan = ops.train_or_kernel(mode, scan, ref.rglru, ops.rglru)
    n_groups, tail = _group_layout(cfg)
    if mode == "train":
        kw = dict(attend=attend, scan=scan, shard_fn=shard_fn)
        for g in range(n_groups):
            x = remat(_train_group, tree_map(lambda a: a[g],
                                             params["groups"]), x, cfg, **kw)
        for i, kind in enumerate(tail):
            x, _ = _apply_kind(params[f"tail{i}_{kind}"], x, cfg, kind,
                               mode=mode, cache=None, pos=None, **kw)
        return x, None
    kw = dict(mode=mode, pos=pos, attend=attend, scan=scan,
              shard_fn=shard_fn)
    keys = [f"b{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
    per_group = []
    for g in range(n_groups):
        pg = tree_map(lambda a: a[g], params["groups"])
        cg = tree_map(lambda a: a[g], cache["groups"]) if cache else None
        x, new = _apply_group(pg, x, cfg, cache=cg, **kw)
        per_group.append(new)
    out = {"groups": {key: {leaf: torch.stack([ng[key][leaf]
                                               for ng in per_group])
                            for leaf in per_group[0][key]}
                      for key in keys}}
    for i, kind in enumerate(tail):
        key = f"tail{i}_{kind}"
        x, out[key] = _apply_kind(params[key], x, cfg, kind,
                                  cache=cache[key] if cache else None, **kw)
    return x, out
