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
  ``begin_emission(..., unpack=True)`` runs it per flush instead, on
  each flushed buffer once its collective has completed (the bucketed
  modes: the scattering read keyed to the flush that produced the
  bytes).
* :func:`reduce_slices` — pack stage + per-slice all-reduce + unpack
  stage over the channel schedule; :func:`reduce_wire` is its part after
  the pack stage.
* :func:`scatter_slices` — the ZeRO-1 exchange: pack stage + per-slice
  reduce-scatter + unpack stage; each peer keeps its ring-ordered chunk
  of every slice (:func:`scatter_group`). A coalesced reduce-scatter
  flush interleaves its items peer-major
  (:func:`interleave_for_scatter`), so every peer's shard is the same
  under every aggregate and flush.

* :func:`emit_flat` — the serving wire: one flat f32 payload (the
  decode step's partial logits, the prefill's gathering write, the moe
  expert exchange) carved into ring-buffer slices and staged through
  the same emission, kind ``all_reduce``, ``all_gather`` or
  ``all_to_all``; :func:`raw_emit` — the unsliced serving emission of
  ``gspmd``, ``sockets`` and ``vma``: one collective for the whole
  payload on the ring's own group.

All-reduces run IN PLACE: when :func:`finish_emission` returns, every
staged buffer holds its sum over the ring (a channel flush copies its
coalesced sum back), so :func:`reduce_slices` unpacks the wire buffer
itself instead of stacking per-item results. A gather or an exchange
writes a fresh buffer per flush, carved back per item when its work
completes. An ``all_to_all`` item is a peer-major ``(group, m)`` block
(row ``p`` for peer ``p``); a coalesced flush interleaves its items
peer-major (:func:`interleave_for_scatter`), so each peer's row of the
exchanged buffer holds every item's chunk in item order.

The chaos seams of the reference (``serving/chaos.py``):

* :func:`set_flush_fault` — ``fault(channel) -> "drop" | "dup" | None``,
  consulted by :func:`flush_ready` once per READY channel. ``"drop"``
  leaves the fill ready: a later :func:`flush_ready` or the
  :func:`finish_emission` barrier flushes it. ``"dup"`` issues a shadow
  flush first: a real second collective (the collective hook sees it)
  on a COPY of the wire bytes, so a single item's in-place all-reduce
  is not summed twice; its results are carved from values equal to the
  real flush's, which overwrites them. Under the leader emission a
  ``"dup"`` issues nothing, as in the reference.
* :func:`set_alloc_hook` — ``hook(channel, nbytes)``, consulted right
  before each wire buffer is built (one per flush, a local lane's under
  the leader emission, and one per item under ``aggregate="slice"``);
  it may sleep or raise.
* :class:`EmissionStats` — ``drops``, ``dups``, ``allocs``, written to
  the innermost :func:`stats_scope` (a ``contextvars.ContextVar``) or
  else to the module's ``EMISSION_STATS``.

The reference consults these seams while JAX traces a step, once per
new shape (its serve-step cache is bypassed while one is armed); the
port runs eagerly and consults them on every call. So a plan's consult
indices count calls here and traces there, and the ``fired`` and
``emissions`` traces of the seams differ between the packages by
design; the served values do not.

The telemetry spans (``obs/trace.py``) sit at the reference's sites: an
``emission`` span from :func:`begin_emission` to :func:`finish_emission`,
``stage`` around :func:`stage_slices` and ``flush`` around each channel
flush (a shadow flush too), each guarded by ``obs_trace.enabled()``.
They fire on every call here, where the reference's fire while a step is
traced; a ``leader_flush`` span covers each leader lane's flush.

Under a pod-aware context (``SyncContext.pod_axis``: the ring has a pod
axis and ``comm.hierarchical`` is on) with ``comm.aggregate="channel"``
the staged emission runs the TWO-LEVEL leader-channel schedule, the UCX
multi-rail analogue: cross-pod links are scarce and get dedicated
lanes. The pool is carved into LOCAL lanes and ``comm.leader_channels``
LEADER lanes (:func:`channels_for`). A local lane's coalesced flush is
the in-pod stage only (an in-pod reduce-scatter or gather) and parks
its intermediate; each leader lane concatenates the intermediates of its
local lanes (``flush_scheduler.make_leader_plan``) into ONE cross-pod
collective, carves them back, and for an all-reduce each lane's in-pod
return gather completes its items. Under ``flush="ready"`` the leader
flushes the moment its last local lane has staged, inside that lane's
``flush`` span; under ``"step"`` in the end-of-exchange loop. The
cross-pod collectives per emission drop from the pool's lanes to its
leader lanes. The port's collectives are asynchronous, so the leader
waits on each parked in-pod work before it concatenates, and an
all-reduce's return gathers wait on the cross-pod one (on NCCL each
communicator has its own stream: the waits order the streams, the host
goes on). An ``all_to_all`` carries source-target traffic over the whole
ring and bypasses the leader split (:func:`begin_emission`). Any other
pod-aware flush (``aggregate="slice"``, a one-lane pool) runs the
channel's two-level ``all_reduce`` / ``reduce_scatter``.

The ZeRO-1 scatter group inside a pod (:func:`scatter_group`) belongs to
training over pods, which waits for the train mesh (ROADMAP.md Queue 1
item 8).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import CommConfig
from repro_torch.core import compress as comp
from repro_torch.core.backends.base import SERVE_KINDS, SyncContext
from repro_torch.core.channels import ChannelFill, CommChannel, make_channels
from repro_torch.core.flush_scheduler import (FlushPlan, make_flush_plan,
                                              make_leader_plan)
from repro_torch.core.hierarchical import in_group_size
from repro_torch.core.ring_buffer import plan_slices
from repro_torch.kernels import ops, ref
from repro_torch.obs import trace as obs_trace

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")

# -- the chaos seams (module docstring) --------------------------------------

_FLUSH_FAULT = None
_ALLOC_HOOK = None


def set_flush_fault(fault) -> None:
    """Install ``fault(channel) -> "drop" | "dup" | None`` on the staged
    emission's flush path. Pair with :func:`clear_flush_fault`
    (try/finally)."""
    global _FLUSH_FAULT
    _FLUSH_FAULT = fault


def clear_flush_fault() -> None:
    global _FLUSH_FAULT
    _FLUSH_FAULT = None


def flush_fault_active() -> bool:
    return _FLUSH_FAULT is not None


@dataclass
class EmissionStats:
    """Emission counters (cumulative; consumers snapshot and diff):
    ``drops``/``dups`` = flush-fault verdicts applied, ``allocs`` =
    wire-buffer allocations consulted."""
    drops: int = 0
    dups: int = 0
    allocs: int = 0


EMISSION_STATS = EmissionStats()

_STATS_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "emission_stats", default=None)


def current_stats() -> EmissionStats:
    """The EmissionStats the seams write to: the innermost armed
    :func:`stats_scope`, else the module's ``EMISSION_STATS``."""
    st = _STATS_SCOPE.get()
    return EMISSION_STATS if st is None else st


@contextlib.contextmanager
def stats_scope(stats: Optional[EmissionStats] = None):
    """Arm a private EmissionStats for the duration of the block (on
    this thread's context); yields it. Nested scopes shadow."""
    st = EmissionStats() if stats is None else stats
    tok = _STATS_SCOPE.set(st)
    try:
        yield st
    finally:
        _STATS_SCOPE.reset(tok)


def set_alloc_hook(hook) -> None:
    """Install ``hook(channel_index, nbytes)`` on every wire-buffer
    allocation. Pair with :func:`clear_alloc_hook` (try/finally)."""
    global _ALLOC_HOOK
    _ALLOC_HOOK = hook


def clear_alloc_hook() -> None:
    global _ALLOC_HOOK
    _ALLOC_HOOK = None


def alloc_hook_active() -> bool:
    return _ALLOC_HOOK is not None


def fault_active() -> bool:
    """Any fault seam armed (flush fault or alloc hook)."""
    return _FLUSH_FAULT is not None or _ALLOC_HOOK is not None


def _consult_alloc(channel_index: int, flats: list) -> None:
    current_stats().allocs += 1
    if _ALLOC_HOOK is not None:
        nbytes = sum(f.numel() * f.element_size() for f in flats)
        _ALLOC_HOOK(channel_index, nbytes)


def leader_emission(ctx: SyncContext, pool_size: int) -> bool:
    """True when the two-level leader-channel schedule applies: a
    pod-aware context, channel-granularity flushes, and a pool big
    enough to carve (a one-channel pool keeps the per-channel
    hierarchical path)."""
    return (ctx.pod_axis is not None and ctx.comm.aggregate == "channel"
            and pool_size >= 2)


def _leader_split(ctx: SyncContext, idx: tuple) -> tuple:
    """Carve the emitting pool into (local, leader) channel ids. The
    global leader lanes are the last ``comm.leader_channels`` ids of the
    ``comm.channels`` pool (the topology-aware affinity pins exactly
    those to the leader loops); a pool that owns none, a non-leader
    event loop's, promotes its last lane, so every loop completes its
    cross-pod stage by itself (which lane carries it changes no value).
    A pool is never left without a local lane."""
    n_lead = min(ctx.comm.leader_channels, ctx.comm.channels - 1)
    tail = range(ctx.comm.channels - n_lead, ctx.comm.channels)
    leads = tuple(i for i in idx if i in tail)
    locs = tuple(i for i in idx if i not in tail)
    if not leads:
        locs, leads = idx[:-1], (idx[-1],)
    if not locs:
        locs, leads = (leads[0],), leads[1:]
    return locs, leads


def channels_for(ctx: SyncContext, n_slices: int) -> list[CommChannel]:
    """The connection pool: at most ``comm.channels`` workers, or
    exactly the context's ``channel_indices`` (an owner's disjoint run of
    the pool), over the ring's channel communicators; pod-aware when the
    context is. Under the two-level schedule (:func:`leader_emission`)
    the pool's leader lanes come back flagged ``leader``, locals
    first."""
    if ctx.ring is None:
        raise ValueError("a sliced emission needs the ring's process "
                         "group and channel communicators: "
                         "SyncContext.ring is None")
    if ctx.channel_indices:
        idx = tuple(ctx.channel_indices)[:max(1, n_slices)]
    else:
        idx = tuple(range(max(1, min(ctx.comm.channels, n_slices))))
    leaders = frozenset()
    if leader_emission(ctx, len(idx)):
        locs, leads = _leader_split(ctx, idx)
        idx = locs + leads
        leaders = frozenset(leads)
    return make_channels(ctx.ring, idx, leaders=leaders,
                         pod_aware=ctx.pod_axis is not None)


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


def _unpack_flush(buf: torch.Tensor, comm: CommConfig) -> torch.Tensor:
    """The unpack stage over ONE flushed buffer (any shape): the
    cast-from-wire pass keyed to the flush, not to the item."""
    if buf.dtype == torch.float32:
        return buf
    return unpack_wire(buf.reshape(1, -1), comm).reshape(buf.shape)


def interleave_for_scatter(flats: list, group: int) -> torch.Tensor:
    """Peer-major coalescing of 1-D wire buffers for ONE reduce-scatter
    flush: peer ``p``'s contiguous ``1/group`` chunk of the result is the
    concatenation of ``p``'s chunk of every buffer, in buffer order — so
    a coalesced reduce-scatter hands every peer exactly the per-item
    shards (and so the ZeRO-1 flat-shard order) of one collective per
    item."""
    if len(flats) == 1:
        return flats[0]
    return torch.cat([f.reshape(group, -1) for f in flats],
                     dim=1).reshape(-1)


def _scattered_shape(shape: tuple, group: int) -> tuple:
    return tuple(shape[:-1]) + (shape[-1] // group,)


@dataclass
class EmitState:
    """In-flight state of one staged emission (built by
    :func:`begin_emission`, driven by :func:`stage_slices` /
    :func:`flush_ready`, closed by :func:`finish_emission`). ``group`` is
    the ring size of an ``all_gather`` (its results are ``group`` times
    the item), a ``reduce_scatter`` (``1/group`` of it) or an
    ``all_to_all`` (the item's ``group`` rows), 1 otherwise;
    ``unpack`` runs the unpack stage per flush. Under the leader
    emission ``chans`` holds the local lanes only (plan group ids stay
    lane ids) and ``leads`` the leader lanes."""
    ctx: SyncContext
    kind: str
    group: int
    unpack: bool
    plan: FlushPlan
    chans: list                   # CommChannel pool (local lanes)
    fills: list                   # per-channel ChannelFill watermark
    staged: dict                  # item id -> wire buffer
    outs: list                    # item id -> result (valid after finish)
    # issued collectives, in issue order: (work, completion)
    issued: list = field(default_factory=list)
    # -- two-level leader emission (empty leads = flat schedule) --------
    leads: list = field(default_factory=list)   # leader CommChannels
    lplan: Optional[FlushPlan] = None   # local lane -> leader lane
    lfills: list = field(default_factory=list)  # per-leader ChannelFill
    pending: dict = field(default_factory=dict)  # local lane -> parked
    #                               in-pod (work, intermediate)
    lpad: dict = field(default_factory=dict)     # local lane -> zero pad
    #                               added for in-pod divisibility
    span: Any = None              # open obs emission-span token (or None)


def _item_spans(st: EmitState, items: list, buf: torch.Tensor,
                group: int = 1):
    """``(item id, its span of buf)`` for a buffer holding ``items`` in
    order, each ``1/group`` of the item's size (a scatter shard) or all
    of it, shaped like the item (its last dim divided by ``group``)."""
    flat, off = buf.reshape(-1), 0
    for i in items:
        n = st.staged[i].numel() // group
        yield i, flat[off:off + n].view(
            _scattered_shape(st.staged[i].shape, group))
        off += n


def _carve_reduce(st: EmitState, items: list, red: torch.Tensor,
                  copy: bool = False) -> Callable:
    """The completion of one all-reduce over ``items``' wire bytes: with
    the per-flush unpack stage, each item's result is its span of the
    unpacked sum; without it, a coalesced sum (or any sum in a buffer of
    its own, ``copy``) is copied back into the items (the scattering
    read; a single item reduced in place is already there)."""
    def carve():
        if st.unpack:
            full = _unpack_flush(red, st.ctx.comm)
            for i, span in _item_spans(st, items, full):
                st.outs[i] = span
        elif copy or len(items) > 1:
            for i, span in _item_spans(st, items, red):
                st.staged[i].copy_(span)
    return carve


def _carve_rows(st: EmitState, items: list, g: torch.Tensor,
                shard: int = 1) -> Callable:
    """The completion of one gather (``shard`` 1) or exchange (``shard``
    = ``group``) over ``items``: the result is peer-major over the whole
    buffer, ``(group, ...)``, and each row holds ``1/shard`` of every
    item in item order, so item i's bytes are the same column range of
    every peer's row."""
    def carve():
        rows = (_unpack_flush(g, st.ctx.comm) if st.unpack
                else g).view(st.group, -1)
        off = 0
        for i in items:
            n = st.staged[i].numel() // shard
            st.outs[i] = rows[:, off:off + n].reshape(-1)
            off += n
    return carve


def _carve_scatter(st: EmitState, items: list,
                   sh: torch.Tensor) -> Callable:
    """The completion of one reduce-scatter over ``items`` (coalesced
    peer-major by :func:`interleave_for_scatter`): each item contributes
    ``1/group`` of its elements to this peer's shard, in item order."""
    def carve():
        full = _unpack_flush(sh, st.ctx.comm) if st.unpack else sh
        for i, span in _item_spans(st, items, full, st.group):
            st.outs[i] = span
    return carve


def _issue(st: EmitState, c: int, items: list,
           shadow: bool = False) -> None:
    """Issue channel ``c``'s ONE collective over ``items``' wire bytes (a
    single item where it lies, or the items coalesced into one buffer:
    concatenated, or peer-major interleaved for a reduce-scatter) and
    record its completion, which runs after the collective has
    completed (:func:`finish_emission`). The alloc hook is consulted
    first. A ``shadow`` flush (the flush fault's ``"dup"``) runs on a
    copy of a single item's bytes, so nothing is reduced twice, and its
    completion is overwritten by the real flush's."""
    ch = st.chans[c]
    flats = [st.staged[i] for i in items]
    _consult_alloc(ch.index, flats)
    if shadow and len(flats) == 1:
        flats = [flats[0].clone()]
    if st.kind in ("reduce_scatter", "all_to_all"):
        buf = interleave_for_scatter([f.reshape(-1) for f in flats],
                                     st.group)
        if st.kind == "all_to_all":
            work, ex = ch.all_to_all(buf)
            st.issued.append((work, _carve_rows(st, items, ex, st.group)))
        else:
            work, sh = ch.reduce_scatter(buf)
            st.issued.append((work, _carve_scatter(st, items, sh)))
        return
    buf = flats[0] if len(flats) == 1 else \
        torch.cat([f.reshape(-1) for f in flats])
    if st.kind == "all_gather":
        work, g = ch.all_gather(buf)
        st.issued.append((work, _carve_rows(st, items, g)))
        return
    work = ch.all_reduce(buf)
    if not st.unpack and not shadow:
        for i in items:
            st.outs[i] = st.staged[i]
    st.issued.append((work, _carve_reduce(st, items, buf)))


def _flush_channel(st: EmitState, c: int, shadow: bool = False) -> None:
    if not obs_trace.enabled():
        return _flush_channel_impl(st, c, shadow)
    with obs_trace.span("flush", f"ch{st.chans[c].index}",
                        channel=st.chans[c].index,
                        items=len(st.plan.groups[c])):
        return _flush_channel_impl(st, c, shadow)


def _flush_channel_impl(st: EmitState, c: int, shadow: bool) -> None:
    """One coalesced wire flush: the channel's staged items as a single
    buffer and ONE collective, carved back when it completes. Under the
    leader emission the flush is the in-pod stage only; its items
    complete when the lane's leader flushes (:func:`_flush_leader`)."""
    if st.leads:
        _stage_local(st, c)
        st.fills[c].flushed = True
        lead = st.lplan.assign[c]
        st.lfills[lead].stage(c)
        if st.ctx.comm.flush == "ready" and st.lfills[lead].ready:
            _flush_leader(st, lead)
        return
    _issue(st, c, list(st.plan.groups[c]), shadow)
    st.fills[c].flushed = True


def _stage_local(st: EmitState, c: int) -> None:
    """The IN-POD stage of local lane ``c``'s coalesced flush (leader
    emission): issue only the in-pod collective and park its work and
    intermediate for the lane's leader. The alloc hook is consulted once,
    for the coalesced buffer. An all-reduce pads to the in-pod size as
    ``psum_hierarchical`` does (the zero tail scatters onto the last
    shard), so the sums are the per-channel hierarchical path's."""
    ch = st.chans[c]
    flats = [st.staged[i].reshape(-1) for i in st.plan.groups[c]]
    _consult_alloc(ch.index, flats)
    if st.kind == "reduce_scatter":
        st.pending[c] = ch.in_pod_reduce_scatter(
            interleave_for_scatter(flats, st.group))
        return
    buf = flats[0] if len(flats) == 1 else torch.cat(flats)
    if st.kind == "all_gather":
        st.pending[c] = ch.in_pod_all_gather(buf)
        return
    pad = (-buf.numel()) % in_group_size(ch.in_pod)
    if pad:
        buf = torch.nn.functional.pad(buf, (0, pad))
    st.lpad[c] = pad
    st.pending[c] = ch.in_pod_reduce_scatter(buf)


def _flush_leader(st: EmitState, lead: int) -> None:
    if not obs_trace.enabled():
        return _flush_leader_impl(st, lead)
    with obs_trace.span("leader_flush", f"lead{st.leads[lead].index}",
                        channel=st.leads[lead].index,
                        lanes=len(st.lplan.groups[lead])):
        return _flush_leader_impl(st, lead)


def _flush_leader_impl(st: EmitState, lead: int) -> None:
    """The CROSS-POD stage: ONE coalesced leader-lane collective over the
    parked in-pod intermediates of leader ``lead``'s local lanes (each
    waited on first), carved back per lane when it completes; for an
    all-reduce each lane's in-pod return gather (issued after the
    cross-pod sum is waited on) then completes the lane's items. This is
    where the cross-pod collectives drop from the pool's lanes to its
    leader lanes."""
    lanes = st.lplan.groups[lead]
    parts = []
    for c in lanes:
        work, part = st.pending.pop(c)
        work.wait()
        parts.append(part)
    lens = [p.numel() for p in parts]
    buf = parts[0] if len(parts) == 1 else torch.cat(parts)
    ch = st.leads[lead]
    if st.kind == "all_gather":
        work, g = ch.cross_pod_all_gather(buf)

        def carve():
            rows = g.view(-1, buf.numel())     # (pods, sum of lane lens)
            off = 0
            for c, n in zip(lanes, lens):
                # (pods, data * len) -> (pods * data, len): the ring's
                # pod-major peer order, as a flat gather's
                lane = rows[:, off:off + n].reshape(st.group, -1)
                off += n
                _carve_rows(st, list(st.plan.groups[c]), lane)()
        st.issued.append((work, carve))
    else:
        work = ch.cross_pod_all_reduce(buf)
        off, spans = 0, []
        for c, n in zip(lanes, lens):
            spans.append((c, buf[off:off + n]))
            off += n
        if st.kind == "reduce_scatter":
            def carve():
                for c, shard in spans:
                    _carve_scatter(st, list(st.plan.groups[c]), shard)()
            st.issued.append((work, carve))
        else:
            work.wait()
            for c, shard in spans:
                items = list(st.plan.groups[c])
                gwork, full = st.chans[c].in_pod_all_gather(shard)
                if st.lpad.get(c):
                    full = full[:full.numel() - st.lpad[c]]
                if not st.unpack:
                    for i in items:
                        st.outs[i] = st.staged[i]
                st.issued.append((gwork, _carve_reduce(st, items, full,
                                                       copy=True)))
    st.lfills[lead].flushed = True


def begin_emission(ctx: SyncContext, n_items: int,
                   kind: str = "all_reduce", *, group: int = 1,
                   unpack: bool = False) -> EmitState:
    """Open one staged emission of ``n_items`` wire buffers through the
    connection pool. The item->channel schedule is ``comm.flush``
    (``core/flush_scheduler``): round-robin with an end-of-exchange flush
    loop under ``"step"``, contiguous production-order groups flushed the
    moment they fill under ``"ready"``. ``group`` is the ring size for
    ``kind="all_gather"``, ``"reduce_scatter"`` and ``"all_to_all"``.
    ``unpack=True`` runs the unpack stage per flush, after its
    collective completes, and the results are f32 (channel-local instead
    of item-local: the scattering read keyed to the flush that produced
    the bytes).

    Under the leader emission (:func:`leader_emission`) the pool splits
    into local lanes (they get the item->channel plan) and leader lanes
    (the second-level lane->leader plan, ``make_leader_plan``). An
    ``all_to_all`` bypasses the split: an exchange carries source-target
    pairs over the whole ring, with no in-pod/cross-pod decomposition,
    so its leader-flagged lanes flush flat like locals."""
    if kind not in KINDS:
        raise ValueError(f"unknown emission kind {kind!r}: expected one "
                         f"of {KINDS}")
    pool = channels_for(ctx, n_items)
    if kind == "all_to_all":
        local, leads = list(pool), []
    else:
        local = [c for c in pool if not c.leader]
        leads = [c for c in pool if c.leader]
    plan = make_flush_plan(n_items, len(local), ctx.comm.flush)
    fills = [ChannelFill(frozenset(g)) for g in plan.groups]
    st = EmitState(ctx=ctx, kind=kind, group=group, unpack=unpack,
                   plan=plan, chans=local, fills=fills, staged={},
                   outs=[None] * n_items)
    if leads:
        st.leads = leads
        st.lplan = make_leader_plan(plan.n_channels, len(leads),
                                    ctx.comm.flush)
        st.lfills = [ChannelFill(frozenset(g)) for g in st.lplan.groups]
    if obs_trace.enabled():
        st.span = obs_trace.begin(
            "emission", kind, items=n_items, channels=len(local),
            leaders=len(leads), aggregate=ctx.comm.aggregate,
            flush=ctx.comm.flush)
    return st


def stage_slices(st: EmitState, i: int, wire: torch.Tensor) -> list:
    if not obs_trace.enabled():
        return _stage_slices_impl(st, i, wire)
    with obs_trace.span("stage", f"item{i}", item=i):
        return _stage_slices_impl(st, i, wire)


def _stage_slices_impl(st: EmitState, i: int, wire: torch.Tensor) -> list:
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
        _issue(st, c, [i])
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
            if _FLUSH_FAULT is not None:
                act = _FLUSH_FAULT(c)
                if act == "drop":
                    # deferred, not lost: the fill stays ready, so a later
                    # flush_ready retries it and finish_emission's step
                    # barrier flushes it unconditionally
                    current_stats().drops += 1
                    continue
                if act == "dup" and not st.leads:
                    current_stats().dups += 1
                    _flush_channel(st, c, shadow=True)
            _flush_channel(st, c)
            flushed.extend(st.plan.groups[c])
    return flushed


def finish_emission(st: EmitState) -> list:
    """Close the emission: under ``flush="step"`` the end-of-exchange
    flush loop (every channel flushed, in channel order, then every
    leader lane under the leader emission); under ``"ready"`` everything
    already went out. Then wait for every issued
    collective in issue order and run its completion (the carve, and the
    per-flush unpack stage). Returns the per-item results: for
    ``all_reduce`` the staged buffers, now reduced (with ``unpack``: the
    f32 sums); for ``all_gather`` each item's ``(group * size,)``
    peer-major gather; for ``reduce_scatter`` each item's shard, its last
    dim divided by ``group``; for ``all_to_all`` each item's exchanged
    ``(group, size / group)`` block, flat."""
    if st.ctx.comm.aggregate == "channel":
        for c, fill in enumerate(st.fills):
            if not fill.flushed:
                if not (fill.ready or st.ctx.comm.flush == "step"):
                    raise RuntimeError(
                        f"emission incomplete: channel {c} is "
                        f"{fill.watermark:.0%} staged")
                _flush_channel(st, c)
        # leader emission, flush="step": the second-level flush loop
        for lead, fill in enumerate(st.lfills):
            if not fill.flushed:
                if not (fill.ready or st.ctx.comm.flush == "step"):
                    raise RuntimeError(
                        f"emission incomplete: leader {lead} is "
                        f"{fill.watermark:.0%} staged")
                _flush_leader(st, lead)
    if len(st.staged) != st.plan.n_items:
        raise RuntimeError(f"emission incomplete: {len(st.staged)} of "
                           f"{st.plan.n_items} items staged")
    for work, done in st.issued:
        work.wait()
        done()
    st.issued.clear()
    if st.span is not None:
        obs_trace.end(st.span)
        st.span = None
    return st.outs


def emit_through_channels(items: list, ctx: SyncContext,
                          kind: str = "all_reduce", *, group: int = 1,
                          unpack: bool = False) -> list:
    """Issue the collective ``kind`` for every item through the
    connection pool at the flush granularity ``comm.aggregate`` and the
    schedule ``comm.flush``, and return the per-item results. All four
    granularity/schedule combinations return bit-identical values."""
    st = begin_emission(ctx, len(items), kind, group=group, unpack=unpack)
    for i, x in enumerate(items):
        stage_slices(st, i, x)
    return finish_emission(st)


def emit_flat(flat: torch.Tensor, ctx: SyncContext,
              kind: str) -> torch.Tensor:
    """The serving wire path: carve ONE flat f32 payload (a partial logit
    sum, a coalesced KV-cache write, a moe expert exchange) into
    ring-buffer slices and emit them through the staged channel schedule
    — the gradient path's gathering write applied to inference traffic.
    ``kind`` is ``"all_reduce"`` (returns the summed payload, ``flat``'s
    own shape), ``"all_gather"`` (returns the peer-major concatenation,
    ``(ring * len,)``) or ``"all_to_all"`` (``flat`` is a peer-major
    ``(ring, len / ring)`` block flattened, row ``p`` for peer ``p``, and
    the result is the received block in the same layout); ``ring`` is
    ``ctx.world_size``. An exchange's plan carves
    the per-peer row, so every slice is itself a peer-major block and
    the exchanged slices re-concatenate per row, as gathered ones do.
    The slice plan's zero padding is trimmed from the result (per peer
    row for gathers and exchanges), so callers see exactly their
    payload. ``flat`` itself is never written: the in-place all-reduce
    runs on a padded copy."""
    if flat.dim() != 1:
        raise ValueError(f"emit_flat takes a flat payload, got "
                         f"{tuple(flat.shape)}")
    if kind not in SERVE_KINDS:
        raise ValueError(f"unknown serving kind {kind!r}: expected one of "
                         f"{SERVE_KINDS}")
    group = 1 if kind == "all_reduce" else ctx.world_size
    rows = group if kind == "all_to_all" else 1
    if flat.numel() % rows:
        raise ValueError(f"an all_to_all payload of {flat.numel()} elements "
                         f"does not split into {rows} peer rows")
    row = flat.numel() // rows
    itemsize = flat.element_size()
    sp = plan_slices(row * itemsize, ctx.comm)
    elems = max(1, sp.slice_bytes // itemsize)
    # the plan's slice count IS the emitted-collective count
    # (dispatch.logit_payload_slices) — never recompute it
    n = sp.n_slices
    if n * elems < row:
        raise ValueError(
            f"slice_bytes={ctx.comm.slice_bytes} is not a multiple of the "
            f"{itemsize}-byte element: {n} slices hold {n * elems} of "
            f"{row} elements")
    buf = flat.new_zeros(rows, n * elems)
    buf[:, :row].copy_(flat.view(rows, row))
    # one row: views of buf (the all-reduce sums in place); more: copies
    outs = emit_through_channels(
        [buf[:, i * elems:(i + 1) * elems].reshape(-1) for i in range(n)],
        ctx, kind, group=group)
    if kind == "all_reduce":
        return buf[0, :row]
    g = outs[0].view(group, -1) if n == 1 else \
        torch.cat([o.view(group, -1) for o in outs], dim=1)
    return g[:, :row].reshape(-1)


def raw_emit(flat: torch.Tensor, ctx: SyncContext,
             kind: str) -> torch.Tensor:
    """The unsliced serving emission (the ``gspmd``, ``sockets`` and
    ``vma`` overrides of ``CommBackend.serve_emit``): ONE collective for
    the whole payload on the ring's own group, no ring-buffer slicing,
    no channel pool. The values equal :func:`emit_flat`'s (summing per
    element and concatenating peer-major commute with slicing); only the
    emission differs. With no ring (one peer, no process group) the
    payload is its own result; given a ring, the collective is issued at
    any ring size, 1 included. ``flat`` itself is never written. An
    ``all_to_all`` payload is a peer-major ``(ring, len / ring)`` block,
    exchanged by one ``all_to_all_single``."""
    if kind not in SERVE_KINDS:
        raise ValueError(f"unknown serving kind {kind!r}: expected one of "
                         f"{SERVE_KINDS}")
    if ctx.ring is None:
        if ctx.world_size != 1:
            raise ValueError(f"a ring of {ctx.world_size} peers needs its "
                             "process group: SyncContext.ring is None")
        return flat
    group = ctx.ring.group
    if kind == "all_reduce":
        out = flat.clone()
        dist.all_reduce(out, group=group)
        return out
    if kind == "all_to_all":
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat.contiguous(), group=group)
        return out
    out = flat.new_empty(ctx.ring.world_size * flat.numel())
    dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out


def reduce_slices(slices: torch.Tensor, ctx: SyncContext):
    """Per-slice all-reduce with the pack/unpack stages, scheduled over
    the channel pool at the configured flush granularity. slices: (n, S)
    f32. Returns (reduced (n, S) f32, new_ef)."""
    wire, new_ef, scale = pack_wire(slices, ctx.ef, ctx.comm)
    return reduce_wire(wire, scale, ctx), new_ef


def reduce_wire(wire: torch.Tensor, scale: Optional[torch.Tensor],
                ctx: SyncContext) -> torch.Tensor:
    """The second half of :func:`reduce_slices`: the per-slice
    all-reduce of :func:`pack_wire`'s ``(wire, scale)`` and the unpack
    stage. Returns the reduced (n, S) f32. A caller that packs and
    reduces in two calls lets the f32 slices go before the emission."""
    if scale is not None:
        # int8: all-gather + local dequant-sum (one fused exchange)
        return comp.int8_allreduce(wire, scale, ctx.ring.group)
    emit_through_channels(list(wire.unbind(0)), ctx, "all_reduce")
    return unpack_wire(wire, ctx.comm)


def scatter_group(ctx: SyncContext):
    """``(gather_group, group_size)`` of the ZeRO-1 reduce-scatter: the
    whole ring. The reference's in-pod group under pod-aware collectives
    belongs to training over pods, which waits for the train mesh
    (ROADMAP.md Queue 1 item 8), and raises."""
    if ctx.ring is None:
        raise ValueError("a ZeRO-1 exchange needs the ring's process "
                         "group: SyncContext.ring is None")
    if ctx.pod_axis is not None:
        raise NotImplementedError(
            f"a ZeRO-1 scatter group inside the pods of axis "
            f"{ctx.pod_axis!r} belongs to training over pods, which waits "
            "for the train mesh in repro_torch (ROADMAP.md Queue 1 item 8)")
    return ctx.ring.group, ctx.ring.world_size


def scatter_slices(slices: torch.Tensor, ctx: SyncContext):
    """Per-slice reduce-scatter (the ZeRO-1 exchange) over the channel
    schedule, with the pack and unpack stages. slices: (n, S) f32.
    Returns ``(flat_shard, new_ef, gather_group)``: this peer's
    ``(n * S/group,)`` shard, slice-major with the peer's ring-ordered
    chunk of every slice, and the group to all-gather it over."""
    gather_group, group = scatter_group(ctx)
    n, s = slices.shape
    if s % group:
        raise ValueError(f"slices of {s} elements do not shard over "
                         f"{group} peers")
    wire, new_ef, scale = pack_wire(slices, ctx.ef, ctx.comm)
    if scale is not None:
        # int8: the full dequant-sum everywhere, then this peer's chunk
        red = comp.int8_allreduce(wire, scale, ctx.ring.group)
        c = s // group
        return red[:, ctx.rank * c:(ctx.rank + 1) * c].reshape(-1), \
            new_ef, gather_group
    shards = emit_through_channels(list(wire.unbind(0)), ctx,
                                   "reduce_scatter", group=group)
    # (n_slices, S/group) -> the flat local shard, ZeRO-1 layout
    return unpack_wire(torch.stack(shards), ctx.comm).reshape(-1), \
        new_ef, gather_group
