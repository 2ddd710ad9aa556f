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
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       embedding_specs, mlp_specs,
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
               attend: Callable, cache_k: Optional[torch.Tensor] = None,
               cache_v: Optional[torch.Tensor] = None,
               pos: Optional[torch.Tensor] = None):
    """Returns (out, k, v): the new K/V at their KV heads (prefill), or
    the caches written in place at ``pos`` (decode). Positions are
    learned and added to the input, so q and k take no rope."""
    q, k, v = att.project_qkv(p, x, x, None, None, 0.0)
    if cache_k is not None:
        out, nk, nv = att.decode_attend(q, cache_k, cache_v, k, v, pos,
                                        num_heads=cfg.num_heads)
        return att.out_project(p, out), nk, nv
    out = attend(q, k, v, causal=causal, window=0)
    return att.out_project(p, out), k, v


def _cross_attn(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """enc_k/v: (B, F, KV, Dh) computed once from the encoder output."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    kx = att.expand_kv(enc_k, cfg.num_heads)
    vx = att.expand_kv(enc_v, cfg.num_heads)
    qpos = torch.arange(x.shape[1], device=x.device)
    kpos = torch.arange(enc_k.shape[1], device=x.device)
    out = att.attend_direct(q, kx, vx, qpos, kpos, causal=False)
    return att.out_project(p, out)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           mode: str = "prefill",
           attend: Optional[Callable] = None) -> torch.Tensor:
    """frames: (B, F, D) embeddings -> the encoder output (B, F, D).
    ``mode`` train takes the plain attention, prefill the kernel."""
    attend = ops.train_or_kernel(mode, attend, att.attend_chunked,
                                 ops.flash_attention)
    x = frames + params["pos_enc"].to(frames.dtype)[None, :frames.shape[1]]
    for i in range(cfg.encoder_layers):
        p = params[f"enc{i}"]
        h = apply_norm(p["ln1"], x, "layernorm")
        a, _, _ = _self_attn(p["attn"], h, cfg, causal=False, attend=attend)
        x = x + a
        h = apply_norm(p["ln2"], x, "layernorm")
        x = x + apply_mlp(p["mlp"], h, "gelu")
    return apply_norm(params["ln_enc"], x, "layernorm")


def cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Every decoder layer's cross K/V (the reference's ``_cross_kv``):
    a (L, B, F, KV, Dh) pair."""
    ks, vs = [], []
    dt = enc_out.dtype
    for i in range(cfg.num_layers):
        p = params[f"dec{i}"]["xattn"]
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
        if "bk" in p:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def decode_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str, cross_k: torch.Tensor, cross_v: torch.Tensor,
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
                                   attend=attend, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos)
        else:
            a, nk, nv = _self_attn(p["attn"], h, cfg, causal=True,
                                   attend=attend)
        x = x + a
        h = apply_norm(p["ln_x"], x, "layernorm")
        x = x + _cross_attn(p["xattn"], h, cfg, enc_k=cross_k[i],
                            enc_v=cross_v[i])
        h = apply_norm(p["ln2"], x, "layernorm")
        x = x + apply_mlp(p["mlp"], h, "gelu")
        new_k.append(nk)
        new_v.append(nv)
    x = apply_norm(params["ln_dec"], x, "layernorm")
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, cache
    return x, {"k": torch.stack(new_k), "v": torch.stack(new_v)}
