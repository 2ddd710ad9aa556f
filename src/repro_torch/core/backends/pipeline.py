"""The slice pipeline of the hadronio-family backends.

Counterpart of ``repro/core/backends/pipeline.py``. One gradient
exchange is a fixed sequence of stages:

    pack -> ring-buffer plan -> pack stage (cast/EF) -> per-channel
    collective -> unpack stage -> unpack

``pack`` and the plan live in :mod:`repro_torch.core.aggregation`; this
module owns the wire stages:

* :func:`pack_wire` — the fused add-error-feedback / cast-to-wire /
  residual pass (the paper's §III-C gathering-write hot spot).
  ``comm.pack="pallas"`` runs the hand-written kernel
  (``kernels.ops.pack_slices``: the CUDA kernel on a CUDA tensor, its
  plain version on a CPU tensor), ``"jnp"`` that plain version
  (``kernels.ref.pack_slices``) on any device; the bytes are the same.
  There is no fallback: a kernel that fails to build or launch raises.
  int8 needs a per-slice amax the kernel does not fuse, so it always
  takes the eager path of ``core/compress``.
* :func:`begin_emission` / :func:`stage_slices` / :func:`flush_ready` /
  :func:`finish_emission` — the worker-per-connection schedule as a
  staged emission: wire buffers are staged in production order and
  flushed per the item->channel schedule of ``core/flush_scheduler``
  (``comm.flush``). The flush granularity is ``comm.aggregate``:
  ``"slice"`` issues each item's collective on its channel as it is
  staged (one channel's collectives run in issue order on its
  communicator), ``"channel"`` coalesces a channel's items into one
  buffer and one collective. Every collective is issued asynchronously;
  :func:`finish_emission` waits for them in issue order, so collectives
  on different channels are in flight together.
  :func:`emit_through_channels` is the one-shot wrapper over the four.
* :func:`unpack_wire` — the unpack stage (the scattering read): one
  cast-from-wire pass over the stacked results, by the same
  ``comm.pack`` switch (``kernels.ops.unpack_slices``).
* :func:`reduce_slices` — pack stage + per-slice all-reduce + unpack
  stage over the channel schedule.

All-reduces run IN PLACE: when :func:`finish_emission` returns, every
staged buffer holds its sum over the ring (a channel flush copies its
coalesced sum back), so :func:`reduce_slices` unpacks the wire buffer
itself instead of stacking per-item results.

Not ported yet, each with the ROADMAP.md item that brings it: the
two-level leader emission and the pod-aware channels (Queue 1 item 8),
``scatter_slices`` for the ZeRO-1 modes (Queue 1 item 4), the serving
emission ``emit_flat``/``raw_emit`` at ring size > 1 (Queue 1 item 3),
and the chaos seams (flush fault, alloc hook) and obs spans (Queue 1
item 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.configs.base import CommConfig
from repro_torch.core import compress as comp
from repro_torch.core.backends.base import SyncContext
from repro_torch.core.channels import ChannelFill, CommChannel, make_channels
from repro_torch.core.flush_scheduler import FlushPlan, make_flush_plan
from repro_torch.kernels import ops, ref

_KINDS = ("all_reduce",)


def channels_for(ctx: SyncContext, n_slices: int) -> list[CommChannel]:
    """The connection pool: at most ``comm.channels`` workers, or
    exactly the context's ``channel_indices`` (an owner's disjoint run of
    the pool), over the ring's channel communicators."""
    if ctx.ring is None:
        raise ValueError("a gradient emission needs the ring's process "
                         "group: SyncContext.ring is None")
    if ctx.channel_indices:
        idx = tuple(ctx.channel_indices)[:max(1, n_slices)]
    else:
        idx = tuple(range(max(1, min(ctx.comm.channels, n_slices))))
    return make_channels(ctx.ring, idx)


def pack_wire(slices: torch.Tensor, ef: Optional[torch.Tensor],
              comm: CommConfig):
    """The pack stage over a ``(n, S)`` f32 slice view: add EF, cast to
    the wire dtype, capture the residual.

    Returns ``(wire, new_ef, int8_scale)``. ``new_ef`` is None when the
    codec carries no residual; a non-None ``int8_scale`` means the caller
    must sum with :func:`comp.int8_allreduce`."""
    if comm.compress == "int8_ef":
        q, scale, new_ef = comp.int8_quantize(slices, ef)
        return q, new_ef, scale
    with_ef = comm.compress == "bf16"
    pack = ops.pack_slices if comm.pack == "pallas" else ref.pack_slices
    n, s = slices.shape
    wire, new_ef = pack(slices.reshape(-1), ef, n_slices=n, slice_elems=s,
                        wire_dtype="bfloat16" if with_ef else "float32",
                        with_ef=with_ef)
    return wire, new_ef, None


def unpack_wire(wire: torch.Tensor, comm: CommConfig) -> torch.Tensor:
    """The unpack stage (the paper's scattering read, §III-C): one
    cast-to-f32 pass over the stacked ``(n, S)`` collective results, by
    the same ``comm.pack`` switch as the pack stage. An f32 wire needs no
    pass at all."""
    if wire.dtype == torch.float32:
        return wire
    unpack = ops.unpack_slices if comm.pack == "pallas" else ref.unpack_slices
    return unpack(wire).reshape(wire.shape)


@dataclass
class EmitState:
    """In-flight state of one staged emission (built by
    :func:`begin_emission`, driven by :func:`stage_slices` /
    :func:`flush_ready`, closed by :func:`finish_emission`)."""
    ctx: SyncContext
    plan: FlushPlan
    chans: list                   # CommChannel pool
    fills: list                   # per-channel ChannelFill watermark
    staged: dict                  # item id -> wire buffer
    # issued collectives, in issue order: (work, completion or None)
    pending: list = field(default_factory=list)


def _carve_reduce(st: EmitState, c: int, red: torch.Tensor) -> Callable:
    """The completion of one channel's coalesced all-reduce: copy each
    item's span of the summed buffer back into the item (the scattering
    read)."""
    def carve():
        off = 0
        for i in st.plan.groups[c]:
            n = st.staged[i].numel()
            st.staged[i].copy_(red[off:off + n].view(st.staged[i].shape))
            off += n
    return carve


def _flush_channel(st: EmitState, c: int) -> None:
    """One coalesced wire flush: the channel's staged items as a single
    contiguous buffer and ONE collective, carved back when it completes
    (a single item is reduced where it lies)."""
    idx = st.plan.groups[c]
    if len(idx) == 1:
        st.pending.append((st.chans[c].all_reduce(st.staged[idx[0]]), None))
    else:
        buf = torch.cat([st.staged[i].reshape(-1) for i in idx])
        st.pending.append((st.chans[c].all_reduce(buf),
                           _carve_reduce(st, c, buf)))
    st.fills[c].flushed = True


def begin_emission(ctx: SyncContext, n_items: int,
                   kind: str = "all_reduce") -> EmitState:
    """Open one staged emission of ``n_items`` wire buffers through the
    connection pool. The item->channel schedule is ``comm.flush``
    (``core/flush_scheduler``): round-robin with an end-of-exchange flush
    loop under ``"step"``, contiguous production-order groups flushed the
    moment they fill under ``"ready"``."""
    if kind not in _KINDS:
        raise NotImplementedError(
            f"emission kind {kind!r} is not ported yet: this slice ports "
            f"{_KINDS} (ROADMAP.md Queue 1 items 3-4)")
    chans = channels_for(ctx, n_items)
    plan = make_flush_plan(n_items, len(chans), ctx.comm.flush)
    fills = [ChannelFill(frozenset(g)) for g in plan.groups]
    return EmitState(ctx=ctx, plan=plan, chans=chans, fills=fills,
                     staged={})


def stage_slices(st: EmitState, i: int, wire: torch.Tensor) -> list:
    """Stage item ``i``'s wire bytes (items are staged in production
    order, 0..n-1) and emit whatever that makes ready:

    * ``aggregate="slice"`` — the item's own collective goes out now,
      after the channel's earlier ones on the same communicator.
    * ``aggregate="channel"``, ``flush="ready"`` — if ``i`` completes its
      channel's set, the channel's coalesced flush goes out now.
    * ``aggregate="channel"``, ``flush="step"`` — staging only; every
      flush waits for :func:`finish_emission` (the step barrier).

    Returns the item ids flushed by this call."""
    st.staged[i] = wire
    c = st.plan.assign[i]
    st.fills[c].stage(i)
    if st.ctx.comm.aggregate == "slice":
        st.pending.append((st.chans[c].all_reduce(wire), None))
        if st.fills[c].ready:
            st.fills[c].flushed = True
        return [i]
    if st.ctx.comm.flush == "ready":
        return flush_ready(st)
    return []


def flush_ready(st: EmitState) -> list:
    """Flush every channel whose fill watermark reached its assigned set
    (the selector reporting writable channels). Returns the item ids
    flushed."""
    flushed: list = []
    for c, fill in enumerate(st.fills):
        if fill.ready:
            _flush_channel(st, c)
            flushed.extend(st.plan.groups[c])
    return flushed


def finish_emission(st: EmitState) -> list:
    """Close the emission: under ``flush="step"`` the end-of-exchange
    flush loop (every channel flushed, in channel order); under
    ``"ready"`` everything already went out. Then wait for every issued
    collective in issue order and carve coalesced results back. Returns
    the per-item results (the staged buffers, now reduced)."""
    if st.ctx.comm.aggregate == "channel":
        for c, fill in enumerate(st.fills):
            if not fill.flushed:
                if not (fill.ready or st.ctx.comm.flush == "step"):
                    raise RuntimeError(
                        f"emission incomplete: channel {c} is "
                        f"{fill.watermark:.0%} staged")
                _flush_channel(st, c)
    if len(st.staged) != st.plan.n_items:
        raise RuntimeError(f"emission incomplete: {len(st.staged)} of "
                           f"{st.plan.n_items} items staged")
    for work, done in st.pending:
        work.wait()
        if done is not None:
            done()
    st.pending.clear()
    return [st.staged[i] for i in range(st.plan.n_items)]


def emit_through_channels(items: list, ctx: SyncContext,
                          kind: str = "all_reduce") -> list:
    """Issue the collective ``kind`` for every item through the
    connection pool at the flush granularity ``comm.aggregate`` and the
    schedule ``comm.flush``, and return the per-item results. All four
    granularity/schedule combinations return bit-identical values."""
    st = begin_emission(ctx, len(items), kind)
    for i, x in enumerate(items):
        stage_slices(st, i, x)
    return finish_emission(st)


def reduce_slices(slices: torch.Tensor, ctx: SyncContext):
    """Per-slice all-reduce with the pack/unpack stages, scheduled over
    the channel pool at the configured flush granularity. slices: (n, S)
    f32. Returns (reduced (n, S) f32, new_ef)."""
    wire, new_ef, scale = pack_wire(slices, ctx.ef, ctx.comm)
    if scale is not None:
        # int8: all-gather + local dequant-sum (one fused exchange)
        return comp.int8_allreduce(wire, scale, ctx.ring.group), new_ef
    emit_through_channels(list(wire.unbind(0)), ctx, "all_reduce")
    return unpack_wire(wire, ctx.comm), new_ef
