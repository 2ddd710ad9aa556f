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
The pod-aware split collectives come with the two-level topology
(ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist


class Ring:
    """The ring of peers one gradient exchange runs over: ``group``
    (None = the default group) and ``channels`` communicators over the
    same ranks, created here in channel order (``new_group`` is
    collective: every rank of the default group must call it, in the
    same order)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None, *,
                 channels: int = 1):
        if channels < 1:
            raise ValueError(f"a ring needs >= 1 channel, got {channels}")
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD)
        self.channel_groups = tuple(dist.new_group(ranks=ranks)
                                    for _ in range(channels))

    def close(self) -> None:
        """Destroy the channel communicators (their device buffers live
        outside PyTorch's allocator); ``group`` is left to its owner.
        Every rank closes its ring, as every rank created it."""
        groups, self.channel_groups = self.channel_groups, ()
        for g in groups:
            dist.destroy_process_group(g)


@dataclass(frozen=True)
class CommChannel:
    index: int
    group: dist.ProcessGroup  # this channel's own communicator

    def all_reduce(self, x: torch.Tensor) -> dist.Work:
        """Sum ``x`` over the ring IN PLACE. The collective is issued
        asynchronously on this channel's communicator; the caller waits
        on the returned work before reading ``x``."""
        return dist.all_reduce(x, group=self.group, async_op=True)

    def all_gather(self, x: torch.Tensor):
        """Concatenate every peer's flat ``x`` peer-major into a fresh
        ``(world * n,)`` buffer: row ``p`` of ``out.view(world, n)`` is
        peer ``p``'s ``x``. Issued asynchronously on this channel's
        communicator; returns ``(work, out)``, and ``out`` is valid once
        the work is waited on."""
        x = x.reshape(-1)
        out = x.new_empty(dist.get_world_size(self.group) * x.numel())
        return dist.all_gather_into_tensor(out, x, group=self.group,
                                           async_op=True), out

    def reduce_scatter(self, x: torch.Tensor):
        """Sum the flat ``x`` over the ring and keep this peer's
        contiguous chunk: ``out`` is ``x.numel() / world`` long and is
        chunk ``rank`` of the sum (the reference's tiled
        ``psum_scatter``). Issued asynchronously on this channel's
        communicator; returns ``(work, out)``, and ``out`` is valid once
        the work is waited on."""
        x = x.reshape(-1)
        world = dist.get_world_size(self.group)
        if x.numel() % world:
            raise ValueError(f"channel {self.index}: a reduce-scatter of "
                             f"{x.numel()} elements does not split over "
                             f"{world} peers")
        out = x.new_empty(x.numel() // world)
        return dist.reduce_scatter_tensor(out, x, group=self.group,
                                          async_op=True), out

    def all_to_all(self, x: torch.Tensor):
        """Peer-major exchange over the ring: the flat ``x`` is a
        ``(world, m)`` block whose row ``p`` is this peer's payload for
        peer ``p``; row ``p`` of the fresh ``out`` is peer ``p``'s payload
        for this peer (the reference's tiled ``all_to_all``, the moe
        expert dispatch and combine). Issued asynchronously on this
        channel's communicator; returns ``(work, out)``, and ``out`` is
        valid once the work is waited on."""
        x = x.reshape(-1)
        world = dist.get_world_size(self.group)
        if x.numel() % world:
            raise ValueError(f"channel {self.index}: an all-to-all of "
                             f"{x.numel()} elements does not split over "
                             f"{world} peers")
        out = torch.empty_like(x)
        return dist.all_to_all_single(out, x, group=self.group,
                                      async_op=True), out

    def _pod_unported(self, what: str):
        return NotImplementedError(
            f"channel {self.index}: {what} belongs to the pod-aware "
            "two-level emission, which is not ported to repro_torch yet "
            "(ROADMAP.md Queue 1 item 8)")

    def in_pod_reduce_scatter(self, x: torch.Tensor):
        raise self._pod_unported("in_pod_reduce_scatter")

    def in_pod_all_gather(self, x: torch.Tensor):
        raise self._pod_unported("in_pod_all_gather")

    def cross_pod_all_reduce(self, x: torch.Tensor):
        raise self._pod_unported("cross_pod_all_reduce")

    def cross_pod_all_gather(self, x: torch.Tensor):
        raise self._pod_unported("cross_pod_all_gather")


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


def make_channels(ring: Ring, indices: tuple) -> list[CommChannel]:
    """The channels ``indices`` of the ring's pool (an event loop that
    owns a run of the pool passes that run)."""
    if any(i >= len(ring.channel_groups) for i in indices):
        raise ValueError(f"channels {indices} asked of a ring with "
                         f"{len(ring.channel_groups)} channel communicators")
    return [CommChannel(int(i), ring.channel_groups[i]) for i in indices]


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
