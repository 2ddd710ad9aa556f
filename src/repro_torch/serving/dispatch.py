"""Serve-step dispatch: inference collectives through the CommBackend wire.

Counterpart of ``repro/serving/dispatch.py``. A :class:`ServeStep` is a
pair of functions with the engine's call signatures —
``prefill(params, batch)`` / ``decode(params, cache, dec)`` — that emit
their collectives through ``CommBackend.serve_emit``:

* **prefill** — batch-sharded: each ring peer prefills its contiguous
  run of the request batch, then every cache leaf plus the last-token
  logits are coalesced into ONE flat f32 payload and all-gathered (the
  serving gathering write), carved back per leaf with the batch rows
  re-merged peer-major at the family's declared batch axis
  (``serving/cache_layout.py``: KV pages, rwkv6's recurrent state and
  recurrentgemma's mixed tree alike).
* **decode** — tensor-parallel LM head: each peer computes partial
  logits from its contiguous ``d_model`` shard and the partial sums are
  all-reduced through the wire.

This slice runs one peer (``n_shards == 1``, no ``torch.distributed``
group) and only the ``gspmd`` backend; the structure is the reference's,
so a later slice widens the ring without restructuring. With no channel
affinity on ``gspmd`` the step is the pure local path (nothing to
wire), as in the reference. There is no jit and no step cache: PyTorch
runs eagerly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import CommConfig, ModelConfig
from repro_torch.core.backends import SyncContext, get_backend
from repro_torch.models import api
from repro_torch.models.common import tree_from_paths, tree_paths
from repro_torch.serving import cache_layout


class ServeStep(NamedTuple):
    """Serve entry points (engine signatures) plus the ring size the
    engine pads batch rows to."""
    prefill: Callable             # (params, batch) -> (logits, cache)
    decode: Callable              # (params, cache, dec) -> (logits, cache)
    n_shards: int                 # ring size: batch rows padded to a multiple


def make_serve_step(cfg: ModelConfig, comm: CommConfig, *,
                    channel_indices: Optional[tuple] = None) -> ServeStep:
    """The serve step for one (model, comm, affinity) combination.
    ``channel_indices`` is the emitting event loop's owned run of the
    channel pool (None = the full pool)."""
    backend = get_backend(comm.mode)
    cache_layout.layout_for(cfg.family)
    chans = tuple(channel_indices) if channel_indices is not None else None
    ctx = SyncContext(comm, world_size=1, rank=0, channel_indices=chans)
    n_shards = ctx.world_size
    # the pure-local reference path: nothing to wire
    pure_local = n_shards == 1 and not chans and comm.mode == "gspmd"

    # -- tensor-parallel LM head (the serving logit reduction) ----------

    def tp_head(embed: dict, x: torch.Tensor) -> torch.Tensor:
        w = embed.get("out")
        if w is None:
            w = embed["tok"].T                       # tied: (d, V)
        d = x.shape[-1]
        ds = -(-d // n_shards)                       # ceil: zero-pad shards
        pad = ds * n_shards - d
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        lo = ctx.rank * ds
        partial = torch.matmul(x[..., lo:lo + ds], w[lo:lo + ds].to(x.dtype))
        red = backend.serve_emit(partial.float().reshape(-1), ctx,
                                 "all_reduce")
        return red.reshape(partial.shape).to(x.dtype)

    # -- batch-sharded prefill + coalesced KV gathering write -----------

    def prefill(params: dict, batch: dict):
        b = batch["tokens"].shape[0]
        if b % n_shards:
            raise ValueError(f"serve batch {b} not padded to the ring size "
                             f"{n_shards}")
        bs = b // n_shards
        lo = ctx.rank * bs
        local = {k: v[lo:lo + bs] for k, v in batch.items()}
        logits, cache = api.prefill(params, local, cfg)
        if pure_local:
            return logits, cache

        # ONE gathering write for the whole prefill result: every cache
        # leaf + the last-token logits as a single flat f32 payload,
        # gathered peer-major, carved back per leaf with the batch axis
        # re-merged (slot k of the full batch = peer k//bs, row k%bs)
        pairs = tree_paths(cache) + [("__logits__", logits)]
        wire = torch.cat([t.float().reshape(-1) for _, t in pairs])
        g = backend.serve_emit(wire, ctx, "all_gather").reshape(n_shards, -1)
        bas = cache_layout.batch_axes(cfg.family, cache) + [0]
        outs, off = [], 0
        for (path, leaf), ba in zip(pairs, bas):
            n = leaf.numel()
            seg = g[:, off:off + n].reshape((n_shards,) + tuple(leaf.shape))
            off += n
            shape = tuple(leaf.shape)
            merged = torch.movedim(seg, 0, ba).reshape(
                shape[:ba] + (n_shards * shape[ba],) + shape[ba + 1:])
            outs.append((path, merged.to(leaf.dtype)))
        full_logits = outs.pop()[1]
        return full_logits, tree_from_paths(outs)

    # -- replicated decode + TP logit reduction -------------------------

    def decode(params: dict, cache: dict, dec: dict):
        return api.decode_step(params, cache, dec, cfg,
                               logits_fn=None if pure_local else tp_head)

    return ServeStep(prefill=prefill, decode=decode, n_shards=n_shards)
