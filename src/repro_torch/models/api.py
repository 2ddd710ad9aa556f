"""Model API of the port (dense, moe, ssm and hybrid families):

  specs(cfg)                                   -> ParamSpec tree
  init(gen, cfg, device=)                      -> params
  loss(params, batch, cfg)                     -> (loss, aux)
  prefill(params, batch, cfg, ...)             -> (last-token logits, cache)
  decode_step(params, cache, batch, cfg, ...)  -> (logits, cache)
  init_cache / grow_cache

Counterpart of ``repro/models/api.py``. ``batch`` is a dict: train
{"tokens", "labels": (B,S) int, "loss_mask"?: (B,S)}; prefill
{"tokens": (B,S) int, "last_pos"?: (B,)}; decode {"token": (B,),
"pos": () or (B,)}. The moe family runs the dense stack with
``models/moe`` in place of the MLP and keeps the dense KV cache. The
ssm family (rwkv6) and the hybrid family (recurrentgemma) serve: their
cache is a recurrent state (plus rolling local-attention pages for the
hybrid), fixed in size. ``loss`` is dense-only until training the other
families is ported. The encdec and vlm families raise
``NotImplementedError`` naming the ROADMAP queue entry that brings them.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as att
from repro_torch.models import hybrid as hyb
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params
from repro_torch.models.layers import (apply_norm, cross_entropy,
                                       embedding_specs, embed_tokens,
                                       lm_logits, norm_specs)

Tree = Any


SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig,
                  families: tuple = SERVED_FAMILIES) -> None:
    if cfg.family not in families:
        what = "" if families == SERVED_FAMILIES else " for training"
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch{what} yet "
            "(ROADMAP.md, Queue 1: 'The other model families')")


def specs(cfg: ModelConfig) -> Tree:
    _check_family(cfg)
    out = {"embed": embedding_specs(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
           "ln_f": norm_specs(cfg.d_model, cfg.norm_kind)}
    if cfg.family == "ssm":
        out["layers"] = rwkv.rwkv_stack_specs(cfg)
        out["ln_in"] = norm_specs(cfg.d_model, "layernorm")
    elif cfg.family == "hybrid":
        out["layers"] = hyb.hybrid_stack_specs(cfg)
    else:
        out["layers"] = tfm.stack_specs(cfg, cfg.family)
    return out


def init(gen: torch.Generator, cfg: ModelConfig,
         device: DeviceLike = None) -> Tree:
    """Random params from ``gen`` on ``device`` (the card unless "cpu")."""
    return init_params(gen, specs(cfg), cfg.param_dtype,
                       resolve_device(device))


def loss(params: Tree, batch: dict, cfg: ModelConfig):
    """Token-mean cross entropy of next-token prediction, and the aux
    dict {"xent", "aux"} of the reference (``aux`` is the MoE balance
    loss, zero for the dense family). Attention is the plain
    ``attend_chunked``, which autograd differentiates. Dense only: the
    moe, ssm and hybrid families serve but do not train yet."""
    _check_family(cfg, ("dense",))
    x = embed_tokens(params["embed"], batch["tokens"],
                     torch_dtype(cfg.compute_dtype))
    x, _, aux = tfm.apply_stack(params["layers"], x, cfg, mode="train")
    x = apply_norm(params["ln_f"], x, cfg.norm_kind)
    logits = lm_logits(params["embed"], x)
    xent = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return xent + aux, {"xent": xent, "aux": aux}


def _trunk(params: Tree, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
           cache=None, pos=None, attend=None, scan=None, expert_fn=None):
    """The family stack. Returns (x, cache). ``expert_fn`` replaces the
    moe expert stage; the other families have none."""
    if cfg.family == "ssm":
        x = apply_norm(params["ln_in"], x, "layernorm")
        return rwkv.apply_rwkv_stack(params["layers"], x, cfg, state=cache,
                                     scan=scan)
    if cfg.family == "hybrid":
        return hyb.apply_hybrid_stack(params["layers"], x, cfg, mode=mode,
                                      cache=cache, pos=pos, attend=attend,
                                      scan=scan)
    x, cache, _ = tfm.apply_stack(params["layers"], x, cfg, mode=mode,
                                  kind=cfg.family, cache=cache, pos=pos,
                                  attend=attend, expert_fn=expert_fn)
    return x, cache


def prefill(params: Tree, batch: dict, cfg: ModelConfig,
            logits_fn: Optional[Callable] = None,
            attend: Optional[Callable] = None,
            scan: Optional[Callable] = None,
            expert_fn: Optional[Callable] = None):
    """Last-token logits (B, V) and the cache. ``logits_fn`` replaces
    the LM head (signature of :func:`layers.lm_logits`; the serving
    dispatch passes its tensor-parallel head). ``attend`` replaces the
    prefill attention (default: the CUDA kernel via
    ``kernels.ops.flash_attention``) and ``scan`` the family's recurrence
    (default: ``kernels.ops.wkv6`` for ssm, ``ops.rglru`` for hybrid);
    the plain versions in ``kernels.ref`` give the plain path.
    ``expert_fn`` replaces the moe expert stage
    (``models/moe.apply_experts``; the serving dispatch passes its
    expert-parallel exchange)."""
    _check_family(cfg)
    head = logits_fn or lm_logits
    x = embed_tokens(params["embed"], batch["tokens"],
                     torch_dtype(cfg.compute_dtype))
    x, cache = _trunk(params, x, cfg, mode="prefill", attend=attend,
                      scan=scan, expert_fn=expert_fn)
    x = apply_norm(params["ln_f"], x, cfg.norm_kind)
    if "last_pos" in batch:     # per-request prompt end (serving engine)
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, batch["last_pos"]][:, None]
    else:
        x_last = x[:, -1:]
    return head(params["embed"], x_last)[:, 0], cache


def decode_step(params: Tree, cache: Tree, batch: dict, cfg: ModelConfig,
                logits_fn: Optional[Callable] = None,
                expert_fn: Optional[Callable] = None):
    """One token for the whole batch against ``cache``. batch: {"token":
    (B,), "pos": () or (B,)}. Attention pages are written in place;
    recurrent states come back as new tensors (rwkv6's decode runs the
    WKV6 kernel at T=1; the hybrid's is the one-line RG-LRU update).
    ``logits_fn`` and ``expert_fn`` as in :func:`prefill`."""
    _check_family(cfg)
    head = logits_fn or lm_logits
    x = embed_tokens(params["embed"], batch["token"][:, None],
                     torch_dtype(cfg.compute_dtype))
    x, cache = _trunk(params, x, cfg, mode="decode", cache=cache,
                      pos=batch["pos"], expert_fn=expert_fn)
    x = apply_norm(params["ln_f"], x, cfg.norm_kind)
    return head(params["embed"], x)[:, 0], cache


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Tree:
    _check_family(cfg)
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    if cfg.family == "ssm":
        return rwkv.init_state(cfg, batch, dt, dev)
    if cfg.family == "hybrid":
        return hyb.init_hybrid_cache(cfg, batch, dt, dev)
    return att.init_kv_cache(cfg.num_layers, batch, _cache_len(cfg, max_len),
                             cfg.num_kv_heads, cfg.head_dim, dt, dev)


def grow_cache(cfg: ModelConfig, cache: Tree, max_len: int) -> Tree:
    """Pad prefill KV caches (sized to the prompt) to ``max_len`` decode
    slots; rolling-window caches and recurrent states are already
    fixed-size."""
    _check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return cache
    tgt = _cache_len(cfg, max_len)

    def grow(x: torch.Tensor) -> torch.Tensor:      # (L, B, S, KV, Dh)
        if x.shape[2] >= tgt:
            return x
        out = x.new_zeros(x.shape[:2] + (tgt,) + x.shape[3:])
        out[:, :, :x.shape[2]] = x
        return out

    return {k: grow(v) for k, v in cache.items()}
