"""Comm channels — the worker-per-connection analogue (paper §III-B).

Counterpart of ``repro/core/channels.py``. hadroNIO gives each
connection its own UCX worker so a selector can poll many of them.
Here a :class:`CommChannel` wraps one ``torch.distributed`` process
group over the ranks of the ring: one communicator per channel, so
channels are independent streams of collectives, while the collectives
of one channel run in issue order on its communicator (the ordering the
reference pins with ``optimization_barrier``). :class:`Ring` owns the
ring's group and creates the channel communicators once, in channel
order on every rank, as ``new_group`` requires; :meth:`Ring.close`
destroys them.

The hadronio-family backends (``core/backends/pipeline``) assign
ring-buffer slices to channels round-robin (paper §IV-C) or, under
``comm.flush="ready"``, contiguously; :class:`ChannelFill` is the
per-channel fill watermark that flush-when-ready polls.

A channel issues four kinds: ``all_reduce`` (the gradient exchange
and the serving logit reduction, in place), ``all_gather`` (the serving
prefill's gathering write, peer-major like the reference's tiled
gather), ``reduce_scatter`` (the ZeRO-1 exchange: each peer keeps
the sum of its contiguous 1/ring chunk) and ``all_to_all`` (the moe
expert exchange: row ``p`` of a peer-major block goes to peer ``p``).

The pod layout (the reference's serve mesh, ``repro/launch/mesh.py``):
a ``Ring`` with a ``pod_axis`` is ``pods`` pods of ``world / pods``
peers laid out pod-major (pod ``p`` holds ranks ``p*d .. p*d+d-1``, the
mesh's device order), and each channel gets, besides its flat
communicator, an in-pod one (its pod's ranks) and a cross-pod one (the
ranks at its in-pod index). A ``pod_aware`` channel runs ``all_reduce``
and ``reduce_scatter`` two-level (``core/hierarchical``), while
``all_gather`` and ``all_to_all`` stay flat; its four split collectives
(``in_pod_reduce_scatter``, ``in_pod_all_gather``,
``cross_pod_all_reduce``, ``cross_pod_all_gather``) are the stages the
leader emission (``core/backends/pipeline``) issues on separate lanes.
A ``leader`` channel is one carved for the cross-pod stage.

The chaos seam :func:`set_collective_hook` installs an observer that
every channel collective calls as ``hook(channel.index, kind)`` when it
is issued. The reference calls it while JAX traces; the port runs
eagerly, so it is called on every issue.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.hierarchical import (in_group_size, psum_hierarchical,
                                           psum_scatter_hierarchical)

_COLLECTIVE_HOOK = None


def set_collective_hook(hook) -> None:
    """Install ``hook(channel_index, kind)`` on every CommChannel
    collective (pair with :func:`clear_collective_hook`, try/finally)."""
    global _COLLECTIVE_HOOK
    _COLLECTIVE_HOOK = hook


def clear_collective_hook() -> None:
    global _COLLECTIVE_HOOK
    _COLLECTIVE_HOOK = None


def get_collective_hook():
    """The installed hook (None when clear), so a wrapper can compose
    with an armed hook and restore it after."""
    return _COLLECTIVE_HOOK


def _note(ch: "CommChannel", kind: str) -> None:
    if _COLLECTIVE_HOOK is not None:
        _COLLECTIVE_HOOK(ch.index, kind)


class Ring:
    """The ring of peers one exchange runs over: ``group`` (None = the
    default group) and ``channels`` communicators over the same ranks,
    created here in channel order (``new_group`` is collective: every
    rank of the default group must call it, in the same order).

    ``pod_axis`` (None = a flat ring, a mesh without a pod axis) names
    the pod axis of a two-level layout of ``pods`` pods, pod-major; then
    each channel also gets its in-pod and cross-pod communicators
    (``in_pod_groups``, ``cross_pod_groups``: this peer's, per channel).
    Every rank creates every subgroup, in the same order. ``pods`` must
    divide the ring size."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None, *,
                 channels: int = 1, pods: int = 1,
                 pod_axis: Optional[str] = None):
        if channels < 1:
            raise ValueError(f"a ring needs >= 1 channel, got {channels}")
        if pods < 1:
            raise ValueError(f"pods must be >= 1, got {pods}")
        n = dist.get_world_size(group) if dist.is_initialized() else 1
        if n % pods != 0:
            raise ValueError(
                f"pods={pods} does not divide the device count {n}; a pod is "
                "a physical partition of the fabric — pick a pod count that "
                f"divides {n} (divisors: "
                f"{[d for d in range(1, n + 1) if n % d == 0]})")
        if pods > 1 and pod_axis is None:
            raise ValueError(f"a ring of {pods} pods needs a pod_axis name")
        if pod_axis == "data":
            raise ValueError("pod_axis 'data' is the ring's in-pod axis; "
                             "name the pod axis otherwise")
        self.group = group
        self.world_size = n
        self.rank = dist.get_rank(group)
        self.pods = pods
        self.pod_axis = pod_axis
        self.pod_size = self.world_size // pods
        ranks = dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD)
        d = self.pod_size
        pod, idx = divmod(self.rank, d)
        self.channel_groups, self.in_pod_groups, self.cross_pod_groups = \
            [], [], []
        for _ in range(channels):
            self.channel_groups.append(dist.new_group(ranks=ranks))
            if pod_axis is None:
                continue
            for p in range(pods):
                g = dist.new_group(ranks=ranks[p * d:(p + 1) * d])
                if p == pod:
                    self.in_pod_groups.append(g)
            for i in range(d):
                g = dist.new_group(ranks=ranks[i::d])
                if i == idx:
                    self.cross_pod_groups.append(g)
        self.channel_groups = tuple(self.channel_groups)
        self.in_pod_groups = tuple(self.in_pod_groups)
        self.cross_pod_groups = tuple(self.cross_pod_groups)

    @property
    def axes(self) -> tuple:
        """The mesh axes this ring stands for, pod first."""
        return ("data",) if self.pod_axis is None else (self.pod_axis,
                                                        "data")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as the reference's ``mesh.shape``."""
        if self.pod_axis is None:
            return {"data": self.world_size}
        return {self.pod_axis: self.pods, "data": self.pod_size}

    def close(self) -> None:
        """Destroy the channel communicators, the pod ones too (their
        device buffers live outside PyTorch's allocator); ``group`` is left
        to its owner. Every rank closes its ring, as every rank created
        it. Only this peer's subgroups are handles here: a subgroup this
        rank is not in was never a communicator on it."""
        groups = self.channel_groups + self.in_pod_groups \
            + self.cross_pod_groups
        self.channel_groups = self.in_pod_groups = self.cross_pod_groups = ()
        for g in groups:
            dist.destroy_process_group(g)


class _CopyBack:
    """The work of a two-level all-reduce run for an in-place caller:
    waiting on it waits the last stage and copies the sum into ``x``."""

    def __init__(self, work, out: torch.Tensor, x: torch.Tensor):
        self.work, self.out, self.x = work, out, x

    def wait(self) -> bool:
        self.work.wait()
        self.x.copy_(self.out.view(self.x.shape))
        return True


@dataclass(frozen=True)
class CommChannel:
    index: int
    group: dist.ProcessGroup  # this channel's own communicator
    in_pod: Optional[dist.ProcessGroup] = None     # this peer's pod
    cross_pod: Optional[dist.ProcessGroup] = None  # its in-pod index
    pod_aware: bool = False   # all_reduce / reduce_scatter two-level
    leader: bool = False      # carved for the cross-pod stage

    def all_reduce(self, x: torch.Tensor):
        """Sum ``x`` over the ring IN PLACE. The collective is issued
        asynchronously on this channel's communicator; the caller waits
        on the returned work before reading ``x``. Pod-aware, it is
        ``psum_hierarchical``'s three stages, and the wait copies the sum
        into ``x``."""
        _note(self, "all_reduce")
        if self.pod_aware:
            work, out = psum_hierarchical(x.reshape(-1), self.cross_pod,
                                          self.in_pod)
            return _CopyBack(work, out, x)
        return dist.all_reduce(x, group=self.group, async_op=True)

    def all_gather(self, x: torch.Tensor):
        """Concatenate every peer's flat ``x`` peer-major into a fresh
        ``(world * n,)`` buffer: row ``p`` of ``out.view(world, n)`` is
        peer ``p``'s ``x``. Issued asynchronously on this channel's
        communicator; returns ``(work, out)``, and ``out`` is valid once
        the work is waited on. Flat on a pod-aware channel too, as the
        reference's."""
        _note(self, "all_gather")
        x = x.reshape(-1)
        out = x.new_empty(dist.get_world_size(self.group) * x.numel())
        return dist.all_gather_into_tensor(out, x, group=self.group,
                                           async_op=True), out

    def reduce_scatter(self, x: torch.Tensor):
        """Sum the flat ``x`` over the ring and keep this peer's
        contiguous chunk: ``out`` is ``x.numel() / world`` long and is
        chunk ``rank`` of the sum (the reference's tiled
        ``psum_scatter``). Pod-aware, the scatter runs in-pod (``out`` is
        ``1/in-pod`` of ``x``, chunk = in-pod index) and the shard is
        summed across pods. Issued asynchronously; returns ``(work,
        out)``, and ``out`` is valid once the work is waited on."""
        x = x.reshape(-1)
        if self.pod_aware:
            _note(self, "reduce_scatter")
            return psum_scatter_hierarchical(x, self.cross_pod, self.in_pod)
        world = dist.get_world_size(self.group)
        if x.numel() % world:
            raise ValueError(f"channel {self.index}: a reduce-scatter of "
                             f"{x.numel()} elements does not split over "
                             f"{world} peers")
        out = x.new_empty(x.numel() // world)
        _note(self, "reduce_scatter")
        return dist.reduce_scatter_tensor(out, x, group=self.group,
                                          async_op=True), out

    def all_to_all(self, x: torch.Tensor):
        """Peer-major exchange over the ring: the flat ``x`` is a
        ``(world, m)`` block whose row ``p`` is this peer's payload for
        peer ``p``; row ``p`` of the fresh ``out`` is peer ``p``'s payload
        for this peer (the reference's tiled ``all_to_all``, the moe
        expert dispatch and combine). Always the whole flat ring: an
        exchange carries source-target traffic, with no in-pod/cross-pod
        split to ride leader lanes. Issued asynchronously on this
        channel's communicator; returns ``(work, out)``, and ``out`` is
        valid once the work is waited on."""
        x = x.reshape(-1)
        world = dist.get_world_size(self.group)
        if x.numel() % world:
            raise ValueError(f"channel {self.index}: an all-to-all of "
                             f"{x.numel()} elements does not split over "
                             f"{world} peers")
        out = torch.empty_like(x)
        _note(self, "all_to_all")
        return dist.all_to_all_single(out, x, group=self.group,
                                      async_op=True), out

    # -- split-level collectives (the two-level leader emission) --------
    # The same stages psum_hierarchical composes, issued on separate
    # lanes: an in-pod stage on a local lane, the cross-pod stage on a
    # leader lane. Splitting them changes no element's sum.

    def _pod_aware(self) -> None:
        if not self.pod_aware:
            raise ValueError(f"channel {self.index}: split-level "
                             "collectives need a pod axis")

    def in_pod_reduce_scatter(self, x: torch.Tensor):
        """In-pod stage of a hierarchical reduce: this peer keeps its
        ``1/in-pod`` chunk of the pod's sum of the flat ``x`` (whose
        length must divide by the in-pod size). Returns ``(work,
        out)``."""
        self._pod_aware()
        x = x.reshape(-1)
        n = in_group_size(self.in_pod)
        if x.numel() % n:
            raise ValueError(f"channel {self.index}: an in-pod "
                             f"reduce-scatter of {x.numel()} elements does "
                             f"not split over {n} peers")
        _note(self, "in_pod_reduce_scatter")
        out = x.new_empty(x.numel() // n)
        return dist.reduce_scatter_tensor(out, x, group=self.in_pod,
                                          async_op=True), out

    def in_pod_all_gather(self, x: torch.Tensor):
        """In-pod gather of the flat ``x`` (the return stage of a
        hierarchical all-reduce, or the local stage of a hierarchical
        gather), in-pod-index-major. Returns ``(work, out)``."""
        self._pod_aware()
        _note(self, "in_pod_all_gather")
        x = x.reshape(-1)
        out = x.new_empty(in_group_size(self.in_pod) * x.numel())
        return dist.all_gather_into_tensor(out, x, group=self.in_pod,
                                           async_op=True), out

    def cross_pod_all_reduce(self, x: torch.Tensor):
        """Cross-pod sum, IN PLACE, of an in-pod-reduced shard: the
        leader lane's collective (``1/in-pod`` of the flat bytes cross
        the scarce link). Returns the work."""
        self._pod_aware()
        _note(self, "cross_pod_all_reduce")
        return dist.all_reduce(x, group=self.cross_pod, async_op=True)

    def cross_pod_all_gather(self, x: torch.Tensor):
        """Cross-pod gather of in-pod-gathered buffers, pod-major: with
        each buffer itself in-pod-index-major, the result is in the ring's
        flat (pod, data) peer order. Returns ``(work, out)``."""
        self._pod_aware()
        _note(self, "cross_pod_all_gather")
        x = x.reshape(-1)
        out = x.new_empty(in_group_size(self.cross_pod) * x.numel())
        return dist.all_gather_into_tensor(out, x, group=self.cross_pod,
                                           async_op=True), out


@dataclass
class ChannelFill:
    """Fill watermark of one channel's gathering write — the selector's
    writable signal (paper §III-B): ``ready`` flips the moment the last
    assigned item is staged."""
    assigned: frozenset           # item ids this channel carries
    staged: set = field(default_factory=set)
    flushed: bool = False

    def stage(self, i: int) -> None:
        if i not in self.assigned or i in self.staged:
            raise ValueError(f"item {i} staged twice or not assigned here "
                             f"(assigned {sorted(self.assigned)}, staged "
                             f"{sorted(self.staged)})")
        self.staged.add(i)

    @property
    def ready(self) -> bool:
        return not self.flushed and self.staged == set(self.assigned)

    @property
    def watermark(self) -> float:
        """Fill fraction in [0, 1] — 1.0 means flushable."""
        return len(self.staged) / max(1, len(self.assigned))


def make_channels(ring: Ring, indices: tuple, *,
                  leaders: frozenset = frozenset(),
                  pod_aware: bool = False) -> list[CommChannel]:
    """The channels ``indices`` of the ring's pool (an event loop that
    owns a run of the pool passes that run). ``leaders`` marks the ids
    carved as cross-pod leader lanes (``pipeline.channels_for`` resolves
    them relative to the emitting pool); ``pod_aware`` gives each channel
    its in-pod and cross-pod communicators, which only a ring with a pod
    axis has."""
    if any(i >= len(ring.channel_groups) for i in indices):
        raise ValueError(f"channels {indices} asked of a ring with "
                         f"{len(ring.channel_groups)} channel communicators")
    if pod_aware and ring.pod_axis is None:
        raise ValueError("pod-aware channels need a ring with a pod axis")
    if not pod_aware:
        return [CommChannel(int(i), ring.channel_groups[i],
                            leader=int(i) in leaders) for i in indices]
    return [CommChannel(int(i), ring.channel_groups[i],
                        ring.in_pod_groups[i], ring.cross_pod_groups[i],
                        pod_aware=True, leader=int(i) in leaders)
            for i in indices]


def round_robin(n_items: int, n_channels: int) -> list[int]:
    """Connection assignment (paper §IV-C assigns connections to
    selectors round-robin)."""
    return [i % n_channels for i in range(n_items)]


def channel_groups(n_items: int, n_channels: int) -> list[list[int]]:
    """The inverse view of :func:`round_robin`: for each channel, the
    item indices it carries, in emission order."""
    groups: list[list[int]] = [[] for _ in range(n_channels)]
    for i, c in enumerate(round_robin(n_items, n_channels)):
        groups[c].append(i)
    return groups
