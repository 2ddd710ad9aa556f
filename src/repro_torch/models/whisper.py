"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

Counterpart of ``repro/models/whisper.py``. The conv/mel frontend is a
stub, as in the reference: the encoder takes precomputed frame
embeddings (B, num_frames, d_model). Learned absolute positions (no
RoPE), LayerNorm + GELU, biases. The few layers are unstacked
(``enc<i>``, ``dec<i>``), as in the reference.

Attention:

* the encoder's self attention is non-causal and the decoder's prefill
  self attention causal, both through ``attend`` (default: the CUDA
  flash kernel via ``kernels.ops.flash_attention``, its plain version
  on CPU tensors), with K/V at their KV heads as
  ``transformer.apply_block`` passes them. The reference runs its jnp
  ``attend_chunked`` there, for which the Pallas flash kernel is the
  named production version. Train mode defaults ``attend`` to that
  plain ``attention.attend_chunked``, which autograd differentiates
  (the kernel has no backward): non-causal in the encoder, causal in
  the decoder;
* cross attention is the plain ``attend_direct`` over the expanded
  cross K/V, as in the reference: queries and keys differ in length,
  which the flash kernel (there and here) does not take;
* decode self attention is ``attention.decode_attend`` against the
  self-attention cache, written in place.

The decode cache is ``{"k", "v"}: (L, B, S, KV, Dh)`` for the decoder's
self attention; the cross K/V ``(L, B, F, KV, Dh)`` are computed once
from the encoder output (``cross_kv``) and held beside it by
``models/api``.

``shard_fn`` (``layers.ShardFn``) reaches the reference's sites and no
others: the q/k/v and output projections of self attention, decode's
flash-decoding layout, cross attention's output projection and each
MLP. The decoder's residual stream is pinned nowhere, as in the
reference. Over a ``DeviceMesh`` every attention runs on each peer's
local blocks (``transformer.attend_blocks``: the batch and the heads
kept, DTensor never folds the two into one batch of products): the
prefill's self attention through the kernel (the encoder's
non-causal), train mode's through the plain ``attend_chunked``, and
cross attention's plain ``attend_direct`` in every mode.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import (ShardFn, apply_mlp, apply_norm,
                                       embedding_specs, mlp_specs, no_shard,
                                       norm_specs)

WHISPER_MAX_POS = 32768   # decoder positions (the reference's table size)


def _enc_block_specs(cfg: ModelConfig) -> dict:
    ds = tfm.depth_scale(cfg)
    return {
        "ln1": norm_specs(cfg.d_model, "layernorm"),
        "ln2": norm_specs(cfg.d_model, "layernorm"),
        "attn": att.attention_specs(cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    cfg.qkv_bias, ds),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, "gelu", ds),
    }


def _dec_block_specs(cfg: ModelConfig) -> dict:
    s = _enc_block_specs(cfg)
    s["ln_x"] = norm_specs(cfg.d_model, "layernorm")
    s["xattn"] = att.attention_specs(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim,
                                     cfg.qkv_bias, tfm.depth_scale(cfg))
    return s


def whisper_specs(cfg: ModelConfig) -> dict:
    specs: dict = {
        "embed": embedding_specs(cfg.vocab_size, cfg.d_model,
                                 cfg.tie_embeddings),
        "pos_enc": ParamSpec((cfg.num_frames, cfg.d_model),
                             ("frames", "embed")),
        "pos_dec": ParamSpec((WHISPER_MAX_POS, cfg.d_model), ("seq", "embed")),
        "ln_enc": norm_specs(cfg.d_model, "layernorm"),
        "ln_dec": norm_specs(cfg.d_model, "layernorm"),
    }
    for i in range(cfg.encoder_layers):
        specs[f"enc{i}"] = _enc_block_specs(cfg)
    for i in range(cfg.num_layers):
        specs[f"dec{i}"] = _dec_block_specs(cfg)
    return specs


def _self_attn(p: dict, x: torch.Tensor, cfg: ModelConfig, *, causal: bool,
               attend: Callable, mode: str, shard_fn: ShardFn = no_shard,
               cache_k: Optional[torch.Tensor] = None,
               cache_v: Optional[torch.Tensor] = None,
               pos: Optional[torch.Tensor] = None):
    """Returns (out, k, v): the new K/V at their KV heads (prefill), or
    the caches written in place at ``pos`` (decode). Positions are
    learned and added to the input, so q and k take no rope. Over a
    mesh ``attend`` runs on each peer's local blocks
    (``transformer.self_attend``)."""
    q, k, v = att.project_qkv(p, x, x, None, None, 0.0, shard_fn)
    if cache_k is not None:
        out, nk, nv = att.decode_attend(q, cache_k, cache_v, k, v, pos,
                                        num_heads=cfg.num_heads,
                                        shard_fn=shard_fn)
        return att.out_project(p, out, shard_fn), nk, nv
    out, k, v = tfm.self_attend(attend, q, k, v, mode=mode, window=0,
                                causal=causal)
    return att.out_project(p, out, shard_fn), k, v


def _cross_attn(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                enc_k: torch.Tensor, enc_v: torch.Tensor,
                shard_fn: ShardFn = no_shard) -> torch.Tensor:
    """enc_k/v: (B, F, KV, Dh) computed once from the encoder output."""
    dt = x.dtype
    q = att._project(x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    if isinstance(q, DTensor):
        out = tfm.attend_blocks(_attend_cross, q, enc_k, enc_v, window=0,
                                causal=False)
    else:
        out = _attend_cross(q, enc_k, enc_v)
    return att.out_project(p, out, shard_fn)


def _attend_cross(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int = 0) -> torch.Tensor:
    """The plain ``attend_direct`` of q (B, S, H, Dh) over the cross K/V
    (B, F, KV, Dh), expanded to q's heads (``transformer.attend_blocks``'
    signature: on a mesh it runs on each peer's local blocks)."""
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    h = q.shape[2]
    return att.attend_direct(q, att.expand_kv(k, h), att.expand_kv(v, h),
                             qpos, kpos, causal=causal, window=window)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           shard_fn: ShardFn = no_shard, *, mode: str = "prefill",
           attend: Optional[Callable] = None) -> torch.Tensor:
    """frames: (B, F, D) embeddings -> the encoder output (B, F, D).
    ``mode`` train takes the plain attention, prefill the kernel."""
    attend = ops.train_or_kernel(mode, attend, att.attend_chunked,
                                 ops.flash_attention)
    x = frames + params["pos_enc"].to(frames.dtype)[None, :frames.shape[1]]
    for i in range(cfg.encoder_layers):
        p = params[f"enc{i}"]
        h = apply_norm(p["ln1"], x, "layernorm")
        a, _, _ = _self_attn(p["attn"], h, cfg, causal=False, attend=attend,
                             mode=mode, shard_fn=shard_fn)
        x = x + a
        h = apply_norm(p["ln2"], x, "layernorm")
        x = x + apply_mlp(p["mlp"], h, "gelu", shard_fn)
    return apply_norm(params["ln_enc"], x, "layernorm")


def cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Every decoder layer's cross K/V (the reference's ``_cross_kv``):
    a (L, B, F, KV, Dh) pair. The projections (and cross attention's
    query) go through ``attention._project``, the heads split after the
    product, as self attention's do."""
    ks, vs = [], []
    dt = enc_out.dtype
    for i in range(cfg.num_layers):
        p = params[f"dec{i}"]["xattn"]
        k = att._project(enc_out, p["wk"].to(dt))
        v = att._project(enc_out, p["wv"].to(dt))
        if "bk" in p:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def decode_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str, cross_k: torch.Tensor, cross_v: torch.Tensor,
                 shard_fn: ShardFn = no_shard,
                 cache: Optional[dict] = None,
                 pos: Optional[torch.Tensor] = None,
                 attend: Optional[Callable] = None):
    """x: the embedded decoder input (B, S, D); cross_k/v: (L, B, F, KV,
    Dh). ``mode`` is train (the plain attention, no cache: returns
    None), prefill (returns the new self-attention cache ``{"k", "v"}:
    (L, B, S, KV, Dh)``) or decode (``cache`` written in place at
    ``pos``, 0-d or (B,), and returned)."""
    attend = ops.train_or_kernel(mode, attend, att.attend_chunked,
                                 ops.flash_attention)
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        p = params[f"dec{i}"]
        h = apply_norm(p["ln1"], x, "layernorm")
        if mode == "decode":
            a, nk, nv = _self_attn(p["attn"], h, cfg, causal=True,
                                   attend=attend, mode=mode,
                                   shard_fn=shard_fn, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos)
        else:
            a, nk, nv = _self_attn(p["attn"], h, cfg, causal=True,
                                   attend=attend, mode=mode,
                                   shard_fn=shard_fn)
        x = x + a
        h = apply_norm(p["ln_x"], x, "layernorm")
        x = x + _cross_attn(p["xattn"], h, cfg, enc_k=cross_k[i],
                            enc_v=cross_v[i], shard_fn=shard_fn)
        h = apply_norm(p["ln2"], x, "layernorm")
        x = x + apply_mlp(p["mlp"], h, "gelu", shard_fn)
        new_k.append(nk)
        new_v.append(nv)
    x = apply_norm(params["ln_dec"], x, "layernorm")
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, cache
    return x, {"k": torch.stack(new_k), "v": torch.stack(new_v)}
