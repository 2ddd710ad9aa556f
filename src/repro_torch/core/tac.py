"""TAC — Transparent Aggregated Communication (the paper's technique).

Counterpart of ``repro/core/tac.py``. ``sync_grads`` is the transparent
boundary: every mode has the same signature, so the model and training
loop never change when the comm stack is swapped. It is a thin façade
over the backend registry (:mod:`repro_torch.core.backends`) with no
per-mode branches. Modes:

  sockets          one all-reduce per gradient tensor (the plain-sockets
                   baseline: per-buffer sends).
  vma              one all-reduce of the whole packed gradient (the
                   libvma analogue).
  hadronio         the paper's gathering write: pack -> ring-buffer
                   slices -> one collective per slice, each on its
                   channel's own communicator.
  hadronio_rs      beyond the paper: per-slice reduce-scatter; the
                   backend updates this peer's ZeRO-1 flat shard and
                   all-gathers the updated parameter slices back.
  hadronio_overlap beyond the paper: DDP-style reverse-layer buckets,
                   each packed and staged in production order.
  hadronio_overlap_rs beyond the paper: the same buckets, each
                   reduce-scattered, with the flat-shard AdamW update
                   (``optim/flat.py``).

``gspmd`` (``manual=False``) never reaches ``sync_grads``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import CommConfig
from repro_torch.core.backends import SyncContext, SyncResult, get_backend
from repro_torch.core.backends.base import EF
from repro_torch.core.channels import Ring

Tree = Any

__all__ = ["SyncResult", "sync_grads"]


def sync_grads(grads: Tree, comm: CommConfig, *, ring: Ring,
               ef: EF = None) -> SyncResult:
    """Sum this peer's gradients over ``ring`` with the strategy
    ``comm.mode`` names; ``ef`` is this peer's error-feedback residual
    (a tensor, or a tuple per bucket). The signature — and so every call
    site — is the same for all modes. The context carries the ring's pod
    axis when ``comm.hierarchical`` is on and the ring has one
    (``SyncContext.pod_axis``), as the reference's TAC body passes its
    ``pod_axis``: the collectives then run two-level and the ZeRO-1
    scatter group is in-pod."""
    ctx = SyncContext(comm, world_size=ring.world_size, rank=ring.rank,
                      ring=ring, ef=ef)
    return get_backend(comm.mode).sync(grads, ctx)
