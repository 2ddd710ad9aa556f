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
* **moe expert parallelism** — when the ring divides the expert count
  (and the step is not the pure local path), the expert stage runs
  expert-parallel in prefill and decode: the dispatched ``(B, E, C, D)``
  buffer is exchanged peer-major (``all_to_all``: each peer receives
  every peer's rows of its own slice of the expert axis), the peer runs
  its ``E / ring`` experts on them, and the reverse exchange brings the
  outputs home. Otherwise the expert stage runs locally. As in the
  reference, the exchanged buffer and the expert weights are f32 on this
  path (``buf.astype(f32)``, ``wslice = mp[w].astype(f32)``), while the
  local stage computes in the compute dtype: the two are bit for bit
  equal on f32 configs only (ROADMAP.md Queue 3).

The ring is a ``core/channels.Ring`` (the reference's mesh): one process
per peer, its rank the peer's place. The hadronio family emits through
the sliced ``pipeline.emit_flat`` over the ring's channel communicators
(``comm.channels``, ``slice_bytes``, ``aggregate`` and ``flush`` all
shape serving traffic, and an event loop's channel affinity bounds
which channels it emits on); ``gspmd``, ``sockets`` and ``vma`` issue
one whole-payload collective on the ring's group
(``pipeline.raw_emit``). Every mode gives the same logits. With no
ring the step serves one peer with no process group, which the pure
local path and ``raw_emit`` accept and the sliced path refuses. With no
channel affinity on ``gspmd`` at ring size 1 the step is the pure local
path (nothing to wire), as in the reference. Serving payloads are
activations, so wire compression is rejected. There is no jit and no
step cache: PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import CommConfig, ModelConfig
from repro_torch.core.backends import SyncContext, get_backend
from repro_torch.core.channels import Ring
from repro_torch.core.ring_buffer import plan_slices
from repro_torch.models import api
from repro_torch.models import moe
from repro_torch.models.common import tree_from_paths, tree_paths
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import cache_layout


class ServeStep(NamedTuple):
    """Serve entry points (engine signatures) plus the ring size the
    engine pads batch rows to."""
    prefill: Callable             # (params, batch) -> (logits, cache)
    decode: Callable              # (params, cache, dec) -> (logits, cache)
    n_shards: int                 # ring size: batch rows padded to a multiple
    comm: CommConfig
    channel_indices: Optional[tuple]


def validate_serve_comm(comm: CommConfig):
    """Serving-path config validation; returns the backend."""
    backend = get_backend(comm.mode)
    if comm.compress != "none":
        raise ValueError(
            f"serving cannot honor compress={comm.compress!r}: the wire "
            "carries activations (logit partial sums, KV gathers), not "
            "gradients — there is no error-feedback state to make a lossy "
            "codec unbiased; use compress='none'")
    return backend


def make_serve_step(cfg: ModelConfig, comm: CommConfig, *,
                    ring: Optional[Ring] = None,
                    channel_indices: Optional[tuple] = None) -> ServeStep:
    """The serve step for one (model, comm, ring, affinity) combination.
    ``ring`` is the ring of peers (None = one peer with no process
    group); ``channel_indices`` is the emitting event loop's owned run of
    the channel pool (None = the full pool). A ``build`` span covers it
    when tracing is on (once per engine: there is no step cache)."""
    if not obs_trace.enabled():
        return _make_serve_step(cfg, comm, ring=ring,
                                channel_indices=channel_indices)
    with obs_trace.span("build", f"serve_step:{cfg.name}",
                        mode=comm.mode, channels=comm.channels):
        return _make_serve_step(cfg, comm, ring=ring,
                                channel_indices=channel_indices)


def _make_serve_step(cfg: ModelConfig, comm: CommConfig, *,
                     ring: Optional[Ring] = None,
                     channel_indices: Optional[tuple] = None) -> ServeStep:
    backend = validate_serve_comm(comm)
    cache_layout.layout_for(cfg.family)
    chans = tuple(channel_indices) if channel_indices is not None else None
    one = ring is None
    ctx = SyncContext(comm, world_size=1 if one else ring.world_size,
                      rank=0 if one else ring.rank, channel_indices=chans,
                      ring=ring)
    n_shards = ctx.world_size
    # the pure-local reference path: nothing to wire (the same gate for
    # the TP head, the gathering write and the expert exchange)
    pure_local = n_shards == 1 and not chans and comm.mode == "gspmd"

    # -- moe expert-parallel stage (the expert exchange) ----------------

    use_ep = (cfg.family == "moe" and not pure_local
              and cfg.moe.num_experts % n_shards == 0)
    ep = cfg.moe.num_experts // n_shards if use_ep else 0

    def ep_experts(mp: dict, buf: torch.Tensor, _cfg) -> torch.Tensor:
        """The expert stage over the ring: exchange the dispatched buffer
        peer-major (peer p gets every peer's rows of experts
        ``p*ep .. p*ep+ep-1``), run this peer's expert slice in f32,
        exchange the outputs back."""
        b, e, cap, d = buf.shape
        snd = buf.float().reshape(b, n_shards, ep, cap, d).movedim(1, 0)
        got = backend.serve_emit(snd.reshape(-1), ctx, "all_to_all")
        lo = ctx.rank * ep
        wslice = {w: mp[w][lo:lo + ep].float() for w in ("wi", "wg", "wo")}
        out = moe.apply_experts(wslice, got.view(n_shards * b, ep, cap, d),
                                cfg)
        back = backend.serve_emit(out.reshape(-1), ctx, "all_to_all")
        back = back.view(n_shards, b, ep, cap, d).movedim(0, 1)
        return back.reshape(b, e, cap, d).to(buf.dtype)

    expert_fn = ep_experts if use_ep else None

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
        logits, cache = api.prefill(params, local, cfg, expert_fn=expert_fn)
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
                               logits_fn=None if pure_local else tp_head,
                               expert_fn=expert_fn)

    return ServeStep(prefill=prefill, decode=decode, n_shards=n_shards,
                     comm=comm, channel_indices=chans)


def logit_payload_slices(cfg: ModelConfig, batch: int,
                         comm: CommConfig) -> int:
    """How many ring-buffer slices one decode logit reduction carves into
    (the collectives per decode step under ``aggregate="slice"``)."""
    return plan_slices(batch * cfg.vocab_size * 4, comm).n_slices


def expert_exchange_slices(cfg: ModelConfig, batch: int, seq: int,
                           comm: CommConfig, n_shards: int = 1) -> int:
    """How many ring-buffer slices one expert exchange carves into: the
    per-peer row of the f32 ``(batch, E, C, D)`` buffer of a call with
    ``batch`` rows of ``seq`` tokens per peer. Under
    ``aggregate="slice"`` a moe layer issues twice this many
    ``all_to_all`` collectives per call (dispatch and combine)."""
    row = batch * cfg.moe.num_experts * moe.capacity(seq, cfg) \
        * cfg.d_model * 4 // n_shards
    return plan_slices(row, comm).n_slices
