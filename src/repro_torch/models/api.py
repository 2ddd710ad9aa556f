"""Model API of the port (every family of the reference):

  specs(cfg)                                   -> ParamSpec tree
  init(gen, cfg, device=)                      -> params
  abstract(cfg)                                -> params as meta tensors
  loss(params, batch, cfg, shard_fn)           -> (loss, aux)
  prefill(params, batch, cfg, shard_fn, ...)   -> (last-token logits, cache)
  decode_step(params, cache, batch, cfg, shard_fn, ...) -> (logits, cache)
  init_cache / grow_cache
  cache_specs(cfg, batch, max_len)             -> the cache as meta tensors
  input_specs(cfg, shape, device=)             -> one cell's inputs, no storage

Counterpart of ``repro/models/api.py``. ``batch`` is a dict: train
{"tokens", "labels": (B,S) int, "loss_mask"?: (B,S)}; prefill
{"tokens": (B,S) int, "last_pos"?: (B,), "frames"|"patches"?}; decode
{"token": (B,), "pos": () or (B,)}. The moe family runs the dense stack
with ``models/moe`` in place of the MLP and keeps the dense KV cache.
The ssm family (rwkv6) and the hybrid family (recurrentgemma) serve:
their cache is a recurrent state (plus rolling local-attention pages
for the hybrid), fixed in size. The encdec family (whisper,
``models/whisper``) takes frame embeddings (B, num_frames, D) and keeps
``{"self": {"k", "v"}, "cross_k", "cross_v"}``; the vlm family (llava)
prepends patch embeddings (B, num_patches, D) to the tokens, runs the
dense stack, and keeps the prefix in the first ``num_patches`` KV slots.
The modality frontends are stubs, as in the reference: frames and
patches arrive as embeddings (``stub_inputs``; a train batch of those
families carries them as ``"frames"`` or ``"patches"``). ``loss`` trains
every family through its stack's train mode, which launches no kernel.

Two quirks of the reference are kept, so that served tokens equal its
own: an encdec prefill reads the logits of the LAST position of the
padded batch, whatever ``last_pos`` says; a vlm prefill reads row
``last_pos`` of the prefixed sequence, so ``last_pos = len - 1`` (the
engine's) lands in the patch prefix (ROADMAP.md, Queue 3).

``loss``, ``prefill`` and ``decode_step`` take the reference's
``shard_fn`` (``layers.ShardFn``, the identity by default; the fourth
argument, as in the reference): the embedded input's ``("batch", "seq",
None)`` constraint (not on encdec's decoder input, which the reference
leaves unpinned), the LM head's, and the sites of every family's stack:
dense, moe and vlm (``models/transformer``, ``models/moe``), ssm
(``models/rwkv6``), hybrid (``models/hybrid``) and encdec
(``models/whisper``). Over a ``DeviceMesh`` (the GSPMD steps of
``launch/steps``) the params and inputs are DTensors; the prefill's
per-row gather at ``last_pos`` and the decoder's learned-position
lookup at ``pos`` are explicit ``local_map``s (:func:`_rows_at`,
:func:`_positions_at`), and the vlm prefix's concat and its ``pos``
offset run on DTensors as they are.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import attention as att
from repro_torch.models import hybrid as hyb
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whi
from repro_torch.models.common import init_params, tree_map
from repro_torch.models.layers import (ShardFn, apply_norm, as_dtensor,
                                       cross_entropy, embedding_specs,
                                       embed_tokens, kept_shards, lm_logits,
                                       no_shard, norm_specs)

Tree = Any


def specs(cfg: ModelConfig) -> Tree:
    if cfg.family == "encdec":
        return whi.whisper_specs(cfg)
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


def abstract(cfg: ModelConfig) -> Tree:
    """The params' layout as ``meta`` tensors in the param dtype (no
    storage)."""
    dt = torch_dtype(cfg.param_dtype)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dt, device="meta"),
                    specs(cfg))


def loss(params: Tree, batch: dict, cfg: ModelConfig,
         shard_fn: ShardFn = no_shard):
    """Token-mean cross entropy of next-token prediction and the
    reference's aux dict: {"xent", "aux"}, ``aux`` the moe balance plus
    z-loss (zero for the other families) added to the loss; {"xent"}
    alone for encdec. Every family runs its stack's train mode: plain
    PyTorch that autograd differentiates (``attend_chunked``,
    ``kernels.ref.wkv6``, ``kernels.ref.rglru``), no kernel, since the
    kernels have no backward. A vlm batch's ``"patches"`` are prepended
    and their rows dropped before the head; an encdec batch's
    ``"frames"`` feed the encoder."""
    dt = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], batch["tokens"], dt)
    head = lambda x: lm_logits(params["embed"], x, shard_fn)
    xent = lambda logits: cross_entropy(logits, batch["labels"],
                                        batch.get("loss_mask"))
    if cfg.family == "encdec":
        enc = whi.encode(params, batch["frames"].to(dt), cfg, shard_fn,
                         mode="train")
        cross_k, cross_v = whi.cross_kv(params, enc, cfg)
        x = x + params["pos_dec"].to(dt)[None, :x.shape[1]]
        x, _ = whi.decode_stack(params, x, cfg, mode="train",
                                cross_k=cross_k, cross_v=cross_v,
                                shard_fn=shard_fn)
        l = xent(head(x))
        return l, {"xent": l}
    prefix = 0
    if cfg.family == "vlm":
        prefix = batch["patches"].shape[1]
        x = torch.cat([batch["patches"].to(dt), x], dim=1)
    x = shard_fn(x, ("batch", "seq", None))
    x, _, aux = _trunk(params, x, cfg, mode="train", shard_fn=shard_fn)
    x = apply_norm(params["ln_f"], x, cfg.norm_kind)
    l = xent(head(x[:, prefix:]))
    return l + aux, {"xent": l, "aux": aux}


def _trunk(params: Tree, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
           cache=None, pos=None, attend=None, scan=None, expert_fn=None,
           shard_fn: ShardFn = no_shard):
    """The family stack. Returns (x, cache, aux): ``aux`` is the moe
    blocks' summed balance loss, zero for the other families.
    ``expert_fn`` replaces the moe expert stage; the other families
    have none. ``shard_fn`` reaches the transformer, rwkv6 and hybrid
    stacks' sites in every mode."""
    zero = lambda: torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = apply_norm(params["ln_in"], x, "layernorm")
        x, state = rwkv.apply_rwkv_stack(params["layers"], x, cfg,
                                         mode=mode, state=cache, scan=scan,
                                         shard_fn=shard_fn)
        return x, state, zero()
    if cfg.family == "hybrid":
        x, cache = hyb.apply_hybrid_stack(params["layers"], x, cfg,
                                          mode=mode, cache=cache, pos=pos,
                                          attend=attend, scan=scan,
                                          shard_fn=shard_fn)
        return x, cache, zero()
    return tfm.apply_stack(params["layers"], x, cfg, mode=mode,
                           kind=cfg.family, cache=cache, pos=pos,
                           attend=attend, expert_fn=expert_fn,
                           shard_fn=shard_fn)


def stub_inputs(cfg: ModelConfig, batch: int,
                device: DeviceLike = None) -> dict:
    """The stub frontends' prefill inputs, as the reference's engine
    feeds them: zero frame embeddings (B, num_frames, D) for encdec,
    zero patch embeddings (B, num_patches, D) for vlm, in the compute
    dtype; nothing for the other families."""
    names = {"encdec": ("frames", cfg.num_frames),
             "vlm": ("patches", cfg.num_patches)}
    if cfg.family not in names:
        return {}
    name, n = names[cfg.family]
    return {name: torch.zeros((batch, n, cfg.d_model),
                              dtype=torch_dtype(cfg.compute_dtype),
                              device=resolve_device(device))}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: str = "meta") -> dict:
    """Model inputs for one cell, the reference's ``input_specs``: the
    same keys and shapes, as storage-free tensors. ``device="meta"``
    gives meta tensors; the dry run passes ``"cpu"`` inside a
    ``FakeTensorMode``, which makes them fake. Token ids are int64, as
    the port's batches are."""
    b, s = shape.global_batch, shape.seq_len
    ids = lambda *dims: torch.empty(dims, dtype=torch.int64, device=device)
    if shape.kind == "decode":
        # one new token against a cache of length seq_len
        return {"token": ids(b), "pos": ids()}
    out = {"tokens": ids(b, s)}
    if shape.kind == "train":
        out["labels"] = ids(b, s)
    prefix = {"encdec": ("frames", cfg.num_frames),
              "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if prefix is not None:
        out[prefix[0]] = torch.empty(
            (b, prefix[1], cfg.d_model),
            dtype=torch_dtype(cfg.compute_dtype), device=device)
    return out


def prefill(params: Tree, batch: dict, cfg: ModelConfig,
            shard_fn: ShardFn = no_shard,
            logits_fn: Optional[Callable] = None,
            attend: Optional[Callable] = None,
            scan: Optional[Callable] = None,
            expert_fn: Optional[Callable] = None):
    """Last-token logits (B, V) and the cache. ``shard_fn`` pins the
    reference's activation constraints (the GSPMD serve step passes
    ``launch/sharding.make_shard_fn(mesh)``): the embedded input's
    ``("batch", "seq", None)``, the dense and vlm stacks' sites and the
    LM head's. ``logits_fn`` replaces the LM head (signature of
    :func:`layers.lm_logits`; the serving dispatch passes its
    tensor-parallel head). ``attend`` replaces the
    prefill attention (default: the CUDA kernel via
    ``kernels.ops.flash_attention``; over a mesh on each peer's local
    blocks, ``transformer.attend_blocks``) and ``scan`` the family's
    recurrence (default: ``kernels.ops.wkv6`` for ssm, ``ops.rglru`` for
    hybrid); the plain versions in ``kernels.ref`` give the plain path.
    ``expert_fn`` replaces the moe expert stage
    (``models/moe.apply_experts``; the serving dispatch passes its
    expert-parallel exchange)."""
    head = logits_fn or lm_logits
    dt = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], batch["tokens"], dt)
    if cfg.family == "encdec":
        enc = whi.encode(params, batch["frames"].to(dt), cfg, shard_fn,
                         attend=attend)
        cross_k, cross_v = whi.cross_kv(params, enc, cfg)
        x = x + params["pos_dec"].to(dt)[None, :x.shape[1]]
        x, cache = whi.decode_stack(params, x, cfg, mode="prefill",
                                    cross_k=cross_k, cross_v=cross_v,
                                    shard_fn=shard_fn, attend=attend)
        # the reference's quirk: the last position, not ``last_pos``
        return head(params["embed"], x[:, -1:], shard_fn)[:, 0], {
            "self": cache, "cross_k": cross_k, "cross_v": cross_v}
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(dt), x], dim=1)
    x = shard_fn(x, ("batch", "seq", None))
    x, cache, _ = _trunk(params, x, cfg, mode="prefill", attend=attend,
                         scan=scan, expert_fn=expert_fn, shard_fn=shard_fn)
    x = apply_norm(params["ln_f"], x, cfg.norm_kind)
    if "last_pos" in batch:     # per-request prompt end (serving engine)
        # vlm: a row of the prefixed sequence (the reference's quirk)
        x_last = _rows_at(x, batch["last_pos"])
    else:
        x_last = x[:, -1:]
    return head(params["embed"], x_last, shard_fn)[:, 0], cache


def _rows_at(x: torch.Tensor, last_pos: torch.Tensor) -> torch.Tensor:
    """``x[b, last_pos[b]]`` for every row b, as (B, 1, D). DTensor has
    no sharding strategy for this gather, so a DTensor ``x`` takes an
    explicit ``local_map``: its batch sharding kept, the sequence
    gathered, each peer reading its own rows (the reference pins no
    constraint here)."""
    def take(xl, pl):
        rows = torch.arange(xl.shape[0], device=xl.device)
        return xl[rows, pl][:, None]

    if not isinstance(x, DTensor):
        return take(x, last_pos)
    mesh = x.device_mesh
    x_pl = kept_shards(x, (0,))
    return local_map(take, out_placements=x_pl, in_placements=(x_pl, x_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, as_dtensor(last_pos, mesh))


def _positions_at(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rows ``pos`` (0-d or (B,)) of a learned position table, as (N, D).
    A DTensor table (its ``embed`` dim split over ``data``) is read on
    each peer's own block of that dim through an explicit ``local_map``,
    ``pos`` whole: DTensor's index has no strategy that keeps the
    table's split."""
    take = lambda t, p: t[p.reshape(-1)]
    if not isinstance(table, DTensor):
        return take(table, pos)
    mesh = table.device_mesh
    t_pl = kept_shards(table, (1,))
    return local_map(take, out_placements=t_pl, in_placements=(
        t_pl, [Replicate()] * mesh.ndim), device_mesh=mesh,
        redistribute_inputs=True)(table, as_dtensor(pos, mesh))


def decode_step(params: Tree, cache: Tree, batch: dict, cfg: ModelConfig,
                shard_fn: ShardFn = no_shard,
                logits_fn: Optional[Callable] = None,
                expert_fn: Optional[Callable] = None):
    """One token for the whole batch against ``cache``. batch: {"token":
    (B,), "pos": () or (B,)}. Attention pages are written in place, at
    the cache's own placement over a mesh, and the given cache object is
    returned (encdec: ``dict(cache, self=...)``, the reference's form,
    holding the given self-attention pages and the same cross K/V
    objects, which no step recomputes); recurrent states come back as
    new tensors (rwkv6's decode
    runs the WKV6 kernel at T=1; the hybrid's is the one-line RG-LRU
    update). ``shard_fn``, ``logits_fn`` and ``expert_fn`` as in
    :func:`prefill`."""
    head = logits_fn or lm_logits
    dt = torch_dtype(cfg.compute_dtype)
    pos = batch["pos"]
    x = embed_tokens(params["embed"], batch["token"][:, None], dt)
    if cfg.family == "encdec":
        # (B, 1, D) per row for a (B,) pos; (1, 1, D) for a 0-d one
        x = x + _positions_at(params["pos_dec"], pos).to(dt)[:, None]
        x, new_self = whi.decode_stack(params, x, cfg, mode="decode",
                                       cross_k=cache["cross_k"],
                                       cross_v=cache["cross_v"],
                                       shard_fn=shard_fn,
                                       cache=cache["self"], pos=pos)
        return head(params["embed"], x, shard_fn)[:, 0], dict(
            cache, self=new_self)
    if cfg.family == "vlm":
        pos = pos + cfg.num_patches   # cache slots 0..P-1 hold the prefix
    x, cache, _ = _trunk(params, x, cfg, mode="decode", cache=cache,
                         pos=pos, expert_fn=expert_fn, shard_fn=shard_fn)
    x = apply_norm(params["ln_f"], x, cfg.norm_kind)
    return head(params["embed"], x, shard_fn)[:, 0], cache


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """KV slots of a decode cache: the rolling window or ``max_len``,
    plus the vlm prefix (encdec: the self-attention cache, at most
    ``WHISPER_MAX_POS``)."""
    if cfg.family == "encdec":
        return min(max_len, whi.WHISPER_MAX_POS)
    n = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    return n + cfg.num_patches


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    """The layout of :func:`init_cache` as ``meta`` tensors in the
    compute dtype (no storage)."""
    dt = cfg.compute_dtype
    if cfg.family == "ssm":
        return rwkv.init_state_specs(cfg, batch, dt)
    if cfg.family == "hybrid":
        return hyb.hybrid_cache_specs(cfg, batch, dt)
    kv = att.kv_cache_specs(cfg.num_layers, batch, _cache_len(cfg, max_len),
                            cfg.num_kv_heads, cfg.head_dim, dt)
    if cfg.family != "encdec":
        return kv
    cross = att.kv_cache_specs(cfg.num_layers, batch, cfg.num_frames,
                               cfg.num_kv_heads, cfg.head_dim, dt)
    return {"self": kv, "cross_k": cross["k"], "cross_v": cross["v"]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Tree:
    dt, dev = torch_dtype(cfg.compute_dtype), resolve_device(device)
    if cfg.family == "ssm":
        return rwkv.init_state(cfg, batch, dt, dev)
    if cfg.family == "hybrid":
        return hyb.init_hybrid_cache(cfg, batch, dt, dev)
    kv = att.init_kv_cache(cfg.num_layers, batch, _cache_len(cfg, max_len),
                           cfg.num_kv_heads, cfg.head_dim, dt, dev)
    if cfg.family != "encdec":
        return kv
    cross = att.init_kv_cache(cfg.num_layers, batch, cfg.num_frames,
                              cfg.num_kv_heads, cfg.head_dim, dt, dev)
    return {"self": kv, "cross_k": cross["k"], "cross_v": cross["v"]}


def grow_cache(cfg: ModelConfig, cache: Tree, max_len: int) -> Tree:
    """Pad prefill KV caches (sized to the prompt) to ``max_len`` decode
    slots (plus the vlm prefix); rolling-window caches, recurrent states
    and encdec's cross K/V are already fixed-size."""
    if cfg.family in ("ssm", "hybrid"):
        return cache
    tgt = _cache_len(cfg, max_len)

    def grow(x: torch.Tensor) -> torch.Tensor:      # (L, B, S, KV, Dh)
        if x.shape[2] >= tgt:
            return x
        out = x.new_zeros(x.shape[:2] + (tgt,) + x.shape[3:])
        out[:, :, :x.shape[2]] = x
        return out

    if cfg.family == "encdec":
        return dict(cache, self=tree_map(grow, cache["self"]))
    return tree_map(grow, cache)
