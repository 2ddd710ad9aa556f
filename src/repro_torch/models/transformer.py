"""Decoder-only transformer stack, dense, moe and vlm families.

Counterpart of ``repro/models/transformer.py``. Parameters are stacked
along a leading ``layers`` dim as in the reference; a Python loop over
the layers replaces ``lax.scan``. A block's ``kind`` is the family:
``moe`` (``models/moe.apply_moe`` in the MLP's place, whose
balance loss each block returns and the stack sums) or any other (its
MLP); ``expert_fn`` replaces the moe expert stage alone (the serving
dispatch's expert-parallel exchange).

``mode``:
  train   — full sequence, causal (optionally windowed), no cache.
  prefill — full sequence, returns the per-layer KV cache.
  decode  — one token per call against the cache (written in place).

Prefill attention is the hand-written CUDA flash-attention kernel
(``kernels.ops.flash_attention``; on CPU tensors its plain version),
where the reference calls its jnp ``attend_chunked``. Train attention is
the plain ``attention.attend_chunked``, as in the reference: the kernel
has no backward (neither has the reference's Pallas kernel), and
autograd differentiates the plain version. ``attend`` overrides the
attention of either mode with another function of the same signature
(q at H heads, k/v at their KV heads, as projected), for example to
hold the prefill kernel against the plain path on the same inputs.
``block_specs``/``apply_block`` take the window
explicitly, so the hybrid stack (``models/hybrid.py``) runs them as its
local-attention blocks with ``window=cfg.local_window``.

``shard_fn`` (``layers.ShardFn``) pins the reference's sequence-parallel
constraints: ``seq_gather`` on each normed input (one all-gather of the
sequence per block under ``REPRO_SP_EXPLICIT=1``, else unconstrained),
``seq`` on the residual after attention and after the MLP, and it is
passed on to the attention and MLP sites, in every mode. Over a
``DeviceMesh`` (DTensor activations) attention runs on each peer's
local blocks in every mode (:func:`attend_blocks`: prefill's kernel,
train mode's plain version), and prefill's new K/V become the cache as
stored values (pending ``Partial`` sums reduced).
The moe block passes ``shard_fn`` on to ``moe.apply_moe``'s own four
sites, whose routing and combine run on each peer's rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import stacked, tree_map
from repro_torch.models.layers import (ShardFn, apply_mlp, apply_norm,
                                       kept_shards, mesh_block, mlp_specs,
                                       no_shard, norm_specs)
from repro_torch.kernels import ops


def depth_scale(cfg: ModelConfig) -> float:
    return 1.0 / (2.0 * max(cfg.num_layers, 1)) ** 0.5


def block_specs(cfg: ModelConfig, kind: str = "dense") -> dict:
    s = {
        "ln1": norm_specs(cfg.d_model, cfg.norm_kind),
        "ln2": norm_specs(cfg.d_model, cfg.norm_kind),
        "attn": att.attention_specs(cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    cfg.qkv_bias, depth_scale(cfg)),
    }
    if kind == "moe":
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                             depth_scale(cfg))
    return s


def stack_specs(cfg: ModelConfig, kind: str = "dense") -> dict:
    return tree_map(lambda s: stacked(s, cfg.num_layers),
                    block_specs(cfg, kind))


def apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                window: int, attend: Callable, kind: str = "dense",
                cache_k: Optional[torch.Tensor] = None,
                cache_v: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                expert_fn: Optional[Callable] = None,
                shard_fn: ShardFn = no_shard):
    """Returns (x, new_cache_k, new_cache_v, aux): ``aux`` is the moe
    block's balance loss, None for a dense block."""
    s = x.shape[1]
    h = apply_norm(p["ln1"], x, cfg.norm_kind)
    h = shard_fn(h, ("batch", "seq_gather", None))   # SP: one AG per block
    if mode != "decode":
        q_positions = torch.arange(s, device=x.device)
    else:
        # 0-d pos -> (s,); per-request (B,) pos -> (B, s)
        q_positions = pos[..., None] + torch.zeros(s, dtype=pos.dtype,
                                                   device=x.device)
    q, k, v = att.project_qkv(p["attn"], h, h, q_positions, q_positions,
                              cfg.rope_theta, shard_fn)
    new_k = new_v = None
    if mode == "decode":
        out, new_k, new_v = att.decode_attend(
            q, cache_k, cache_v, k, v, pos, num_heads=cfg.num_heads,
            window=window, shard_fn=shard_fn)
    else:
        # k/v at their KV heads: the kernel reads GQA/MQA in place, the
        # plain versions expand them themselves
        out, k, v = self_attend(attend, q, k, v, mode=mode, window=window)
        if mode == "prefill":
            if window > 0:     # rolling layout for windowed decode caches
                new_k, new_v = att.to_rolling(k, window), att.to_rolling(
                    v, window)
            else:
                new_k, new_v = k, v
    x = x + att.out_project(p["attn"], out, shard_fn)
    x = shard_fn(x, ("batch", "seq", None))
    h = apply_norm(p["ln2"], x, cfg.norm_kind)
    h = shard_fn(h, ("batch", "seq_gather", None))   # SP: one AG per block
    if kind == "moe":
        y, aux = moe_mod.apply_moe(p["moe"], h, cfg, shard_fn,
                                   expert_fn=expert_fn)
    else:
        y, aux = apply_mlp(p["mlp"], h, cfg.mlp_kind, shard_fn), None
    return shard_fn(x + y, ("batch", "seq", None)), new_k, new_v, aux


def self_attend(attend: Callable, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, *, mode: str, window: int,
                causal: bool = True):
    """(``attend(q, k, v)``, k, v): over a mesh on each peer's local
    blocks (:func:`attend_blocks`), and in prefill with k/v as the
    stored values the cache keeps."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, causal=causal, window=window), k, v
    if mode == "prefill":
        k, v = _stored(k), _stored(v)
    return attend_blocks(attend, q, k, v, window=window,
                         causal=causal), k, v


def _stored(t: DTensor) -> DTensor:
    """``t`` with its pending sums (``Partial``) reduced: a cache holds
    values, not partial sums."""
    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(
        t.device_mesh, pl)


def attend_blocks(attend: Callable, q: DTensor, k: DTensor, v: DTensor, *,
                  window: int, causal: bool = True) -> DTensor:
    """``attend`` (causal, or not: whisper's encoder) on each peer's local
    blocks of DTensor q/k/v, through an explicit ``local_map``, in every
    mode: the kernel's wrapper reads ``data_ptr()`` and takes plain,
    contiguous tensors, so no DTensor reaches it; train mode's plain
    ``attend_chunked`` runs there under autograd, so DTensor never folds
    the split batch and heads into one batch of products (torch 2.11
    refuses that flatten; 2.13 makes a strided shard whose
    redistributions its graph planner searches at seconds a call). q keeps the batch and heads sharding that
    ``project_qkv`` pinned (every other dim gathered: each peer needs
    its rows' whole sequence); k/v keep the batch's, and the KV heads'
    where they split over the same mesh dims as the query heads.
    Otherwise (``heads`` divides the ``model`` axis and ``kv_heads`` does
    not) k/v arrive whole and each peer takes the KV heads its own query
    heads read in global numbering, query head ``g`` reading KV head
    ``g // (H // KV)``: a slice of whole groups, the one KV head all of
    them read, or one KV head per query head."""
    mesh = q.device_mesh
    h, kv = q.shape[2], k.shape[2]
    q_pl = kept_shards(q, (0, 2))
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    kv_split = bool(heads) and all(k.placements[i] == Shard(2)
                                   for i in heads)
    kv_pl = [p if p == Shard(0) or (p == Shard(2) and kv_split)
             else Replicate() for p in q_pl]
    take = None                 # which KV heads this peer's queries read
    if heads and not kv_split:
        block, n = mesh_block(mesh, heads)
        h_loc, g = h // n, h // kv
        first = block * h_loc
        if h_loc % g == 0:
            take = slice(first // g, (first + h_loc) // g)
        elif g % h_loc == 0:
            take = slice(first // g, first // g + 1)
        else:
            take = torch.arange(first, first + h_loc) // g

    def local(ql, kl, vl):
        if take is not None:
            if isinstance(take, torch.Tensor):
                idx = take.to(kl.device)
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
            else:
                kl, vl = kl[:, :, take], vl[:, :, take]
        return attend(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                      causal=causal, window=window)

    # train mode: where k/v arrive whole over the query heads' mesh dims,
    # each peer's gradient covers the KV heads its queries read: a sum
    kv_grad = [Partial() if take is not None and i in heads else p
               for i, p in enumerate(kv_pl)]
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def apply_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, kind: str = "dense",
                cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None,
                attend: Optional[Callable] = None,
                expert_fn: Optional[Callable] = None,
                shard_fn: ShardFn = no_shard):
    """Run the block over the stacked params. Returns (x, cache, aux):
    ``cache`` is {"k","v"}: (L,B,S,KV,Dh) for prefill (new) and decode
    (the given cache, updated in place), None in train mode; ``aux`` is
    the blocks' balance losses summed (zero for dense)."""
    attend = ops.train_or_kernel(mode, attend, att.attend_chunked,
                                 ops.flash_attention)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.num_layers):
        p = tree_map(lambda t: t[layer], params)
        ck = cache["k"][layer] if mode == "decode" else None
        cv = cache["v"][layer] if mode == "decode" else None
        x, nk, nv, a = apply_block(p, x, cfg, mode=mode, kind=kind,
                                   window=cfg.sliding_window, attend=attend,
                                   cache_k=ck, cache_v=cv, pos=pos,
                                   expert_fn=expert_fn, shard_fn=shard_fn)
        if a is not None:
            aux = aux + a
        ks.append(nk)
        vs.append(nv)
    if mode == "train":
        return x, None, aux
    if mode == "prefill":
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}, aux
    return x, cache, aux
