"""Elastic scaling: continue a run on a ring of another size, or a
serving fleet on another number of event loops.

Counterpart of ``repro/launch/elastic.py``.
Checkpoints hold the reference's global layout (``checkpoint/store.py``:
each ring-sharded leaf stacked along a leading ring dim), so elasticity
is: build the new ring, restore, continue. Two things are re-derived on
a change of ring size:

* the ZeRO-1 modes' flat moment shards, whose length depends on the
  ring size: the owning backend's ``reshard_flat_shards`` re-slices them
  (the global flat vector is the invariant; the segment layout, ring
  slices or overlap buckets, is the backend's);
* the data order needs nothing: batches are addressed by (step, global
  index), so another ring reads the same global batch
  (``data.DataConfig.host_index``).

The serving half resizes the event-loop fleet at a flush boundary:
:func:`reshard_event_loops` re-validates the ``ServeConfig`` and
:func:`reshard_affinity` re-derives the channel partition, with minimal
migration on the flat fabric and recomputed in its topology form
(leader lanes, pods).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.checkpoint import CheckpointStore
from repro_torch.compat import DeviceLike
from repro_torch.configs.base import RunConfig
from repro_torch.core.backends import get_backend
from repro_torch.core.channels import Ring
from repro_torch.launch import steps as steps_mod
from repro_torch.optim.flat import reshard_ring_segments


def reshard_tac_opt(flat_mu: np.ndarray, flat_nu: np.ndarray,
                    old_shards: int, new_shards: int, n_slices: int):
    """Re-slice ``hadronio_rs``-style flat moment shards for a new ring
    size (a thin wrapper over :func:`optim.flat.reshard_ring_segments`;
    the live restore path goes through the backend's
    ``reshard_flat_shards``). Saved checkpoints hold the global stacked
    shards ``(old_shards, shard_len)``; the global flat layout is
    ``n_slices`` equal segments. Returns ``(new_mu, new_nu)`` of shape
    ``(new_shards, new_shard_len)``."""
    seg = [flat_mu.shape[1] * old_shards // n_slices] * n_slices
    return (reshard_ring_segments(flat_mu, old_shards, new_shards, seg),
            reshard_ring_segments(flat_nu, old_shards, new_shards, seg))


def make_on_mismatch(run: RunConfig):
    """Shape-mismatch resolver for elastic restores (the store's
    ``on_mismatch``). Ring-sized state is backend-owned, so the re-slice
    rule is the backend's ``reshard_flat_shards`` (ZeRO-1 flat moments,
    including the replan-and-zero path an odd scatter group takes, where
    even the total flat length changes). Error-feedback residuals are
    per peer and keyed to the ring or bucket layout, so any mismatch
    resets them to zero (one uncompensated step of truncation). Leaves
    are told apart by their checkpoint file name (``.ef...`` against
    ``.opt_...``), not by shape: an overlap bucket's residual and a flat
    moment shard are both 2-D. None when the run has no ring-sized
    state."""
    backend = get_backend(run.comm.mode)
    if not backend.zero1 and run.comm.compress == "none":
        return None

    def on_mismatch(name: str, arr: np.ndarray, ref) -> np.ndarray:
        want = tuple(ref.shape)
        if name.startswith(".ef") and arr.ndim == len(want):
            return np.zeros(want, np.float32)
        if arr.ndim == 2 and len(want) == 2:
            out = backend.reshard_flat_shards(run, np.asarray(arr), want[0])
            if tuple(out.shape) != want:
                raise ValueError(
                    f"{name}: backend resharded {arr.shape} -> {out.shape},"
                    f" expected {want}")
            return out
        if arr.ndim == len(want) and arr.shape[1:] == want[1:]:
            # leading ring dim changed on a per-peer residual: reset
            return np.zeros(want, np.float32)
        raise ValueError(f"{name}: cannot reshard {arr.shape}->{want}")

    return on_mismatch


def restore_elastic(store: CheckpointStore, run: RunConfig, ring: Ring,
                    step: Optional[int] = None, *,
                    device: DeviceLike = None):
    """Restore the latest (or the given) checkpoint onto ``ring``, which
    may have another size than the ring that saved it. ``store`` must be
    built on the ring's group with ``steps.ring_rows``. Returns
    ``(state, step)``: this peer's state on ``device`` (the card unless
    "cpu")."""
    if (store.world, store.rank) != (ring.world_size, ring.rank):
        raise ValueError(
            f"the store is built for peer {store.rank} of {store.world}, "
            f"the ring is peer {ring.rank} of {ring.world_size}: build the "
            "store on the ring's group")
    s = store.latest_step() if step is None else step
    if s is None:
        raise FileNotFoundError(f"no checkpoint under {store.dir}")
    like = steps_mod.abstract_state(run, ring.world_size)
    state = store.restore(s, like, on_mismatch=make_on_mismatch(run),
                          device=device)
    return state, s


def reshard_event_loops(serve, new_loops: int):
    """Elastic reshard of the SERVING fleet: a re-validated
    ``ServeConfig`` with ``event_loops=new_loops`` (``replace`` re-runs
    the config's checks, so a loop count the channel pool cannot feed
    raises here, not mid-request). Served tokens do not depend on the
    loop count, so a group rebuilt with it at a flush boundary continues
    with the same tokens."""
    return dataclasses.replace(serve, event_loops=new_loops)


def _minimal_regroup(n_channels: int, old_groups: tuple, new_loops: int):
    """Minimal-migration repartition of the flat fabric. Shrink: the
    surviving loops keep their runs and the removed tail loops' channels
    join the last survivor. Grow by ``k``: added loop ``i`` takes the one
    channel ``n-k+i`` from the pool's tail; donors keep their prefixes.
    None when the minimal move would break an ownership invariant (a
    donor emptied, a run not contiguous): the caller recomputes.
    Balance to within one is not kept: fewer owner changes is the
    point."""
    old_k = len(old_groups)
    if new_loops == old_k:
        return old_groups
    if new_loops < old_k:
        groups = [list(g) for g in old_groups[:new_loops]]
        tail = sorted(c for g in old_groups[new_loops:] for c in g)
        groups[-1] = sorted(groups[-1] + tail)
    else:
        add = new_loops - old_k
        donate = set(range(n_channels - add, n_channels))
        groups = [[c for c in g if c not in donate] for g in old_groups]
        if any(not g for g in groups):
            return None               # a donor would own nothing
        groups += [[c] for c in sorted(donate)]
    for g in groups:                  # contiguous runs only
        if list(g) != list(range(min(g), max(g) + 1)):
            return None
    if sorted(c for g in groups for c in g) != list(range(n_channels)):
        return None                   # disjoint + covering
    return tuple(tuple(g) for g in groups)


def reshard_affinity(n_channels: int, old_groups, new_loops: int, *,
                     n_pods: int = 1, leaders: int = 0,
                     leader_loops: int = 1):
    """Re-derive the channel partition for a resized fleet and report the
    migration: ``(new_groups, moved)``, ``moved`` the sorted channel ids
    whose owning loop changed. Ownership stays disjoint, contiguous and
    covering. The flat fabric migrates minimally
    (:func:`_minimal_regroup`), else recomputes ``channel_affinity``. The
    topology form (``leaders > 0`` or ``n_pods > 1``) always recomputes
    ``channel_affinity``'s topology form: pod alignment and leader
    pinning are worth the extra migrations."""
    from repro_torch.serving.event_loop import channel_affinity
    old_groups = tuple(tuple(g) for g in old_groups)
    if new_loops > n_channels:
        channel_affinity(n_channels, new_loops)   # the ownership error
    new_groups = None
    if leaders <= 0 and n_pods <= 1:
        new_groups = _minimal_regroup(n_channels, old_groups, new_loops)
    if new_groups is None:
        new_groups = channel_affinity(n_channels, new_loops, n_pods=n_pods,
                                      leaders=leaders,
                                      leader_loops=leader_loops)
    old_owner = {c: i for i, g in enumerate(old_groups) for c in g}
    moved = tuple(sorted(
        c for i, g in enumerate(new_groups) for c in g
        if old_owner.get(c) != i))
    return new_groups, moved
