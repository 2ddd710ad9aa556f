"""Flush-when-ready channel scheduling (paper §III-B/III-C).

Counterpart of ``repro/core/flush_scheduler.py``. hadroNIO flushes a
connection's ring buffer the moment its data is ready. ``comm.flush``
selects the schedule of one exchange:

* ``"step"`` — items land on channels round-robin and every channel
  flushes in one end-of-exchange loop (a single ``flush()`` at the step
  barrier).
* ``"ready"`` — items are grouped onto channels contiguously in
  production order (:func:`repro_torch.core.selector.ready_groups`), and
  a channel's coalesced collective goes out the moment the last item
  assigned to it is staged.

Both schedules move the same bytes per item and give bit-identical
results: a sum is elementwise, so grouping changes no element's sum.
:func:`make_leader_plan` is the second level of the pod-aware leader
emission: local lanes onto the leader lanes that carry their cross-pod
collective.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.channels import channel_groups
from repro_torch.core.selector import ready_groups

FLUSHES = ("step", "ready")


class FlushPlan(NamedTuple):
    """Item->channel schedule of one exchange (shape-only)."""
    n_items: int
    flush: str                # "step" | "ready"
    groups: tuple             # per channel: item ids, in staging order
    triggers: tuple           # per channel: the item id whose staging
    #                           makes the channel ready (max of the group)
    assign: tuple             # item id -> channel index

    @property
    def n_channels(self) -> int:
        return len(self.groups)

    @property
    def readiness_depth(self) -> int:
        """Items that must be produced before the first flush can go out
        (``step`` flushes nothing before the end of the exchange)."""
        if self.flush != "ready":
            return self.n_items
        return min(self.triggers) + 1

    @property
    def contiguous(self) -> bool:
        """True when every channel's items are one contiguous run."""
        return all(g == tuple(range(g[0], g[0] + len(g)))
                   for g in self.groups if g)


def _check(flush: str, **counts: int) -> None:
    if flush not in FLUSHES:
        raise ValueError(f"unknown flush schedule {flush!r}: expected one "
                         f"of {FLUSHES}")
    for name, n in counts.items():
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")


def make_flush_plan(n_items: int, n_channels: int,
                    flush: str = "step") -> FlushPlan:
    """Map ``n_items`` slices onto at most ``n_channels`` channels under
    the given schedule. Items are staged in production order (0..n-1),
    so a channel's readiness trigger is the largest id it carries."""
    _check(flush, n_items=n_items)
    n_channels = max(1, min(n_channels, n_items))
    if flush == "ready":
        groups = ready_groups(n_items, n_channels)
    else:
        groups = tuple(tuple(g)
                       for g in channel_groups(n_items, n_channels))
    assign = [0] * n_items
    triggers = []
    for c, g in enumerate(groups):
        for i in g:
            assign[i] = c
        triggers.append(max(g))
    return FlushPlan(n_items, flush, groups, tuple(triggers),
                     tuple(assign))



def make_leader_plan(n_local: int, n_leaders: int,
                     flush: str = "step") -> FlushPlan:
    """The SECOND level of the hierarchical emission: map the local-lane
    flushes (the in-pod stages, ids ``0..n_local-1``) onto the leader
    lanes that carry their coalesced cross-pod collective. The grouping
    is always contiguous (``ready_groups``): local lanes flush in lane
    order under both schedules, so contiguous runs give each leader the
    earliest readiness. ``flush`` only decides the trigger: under
    ``"ready"`` a leader's cross-pod flush goes out the moment the last
    local lane assigned to it has staged its in-pod shard; under
    ``"step"`` leaders flush in the end-of-exchange loop, after every
    local lane."""
    _check(flush, n_local=n_local, n_leaders=n_leaders)
    n_leaders = min(n_leaders, n_local)
    groups = ready_groups(n_local, n_leaders)
    assign = [0] * n_local
    triggers = []
    for lead, g in enumerate(groups):
        for c in g:
            assign[c] = lead
        triggers.append(max(g))
    return FlushPlan(n_local, flush, groups, tuple(triggers),
                     tuple(assign))
