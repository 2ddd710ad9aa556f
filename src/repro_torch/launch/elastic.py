"""Elastic scaling, training side: continue a run on a ring of another
size.

Counterpart of the training half of ``repro/launch/elastic.py``.
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

The serving half (``reshard_event_loops``, ``reshard_affinity``) is
still to port, with the supervisor (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

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
