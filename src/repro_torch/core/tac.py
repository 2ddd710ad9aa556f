"""TAC — Transparent Aggregated Communication (the paper's technique).

Counterpart of ``repro/core/tac.py``. ``sync_grads`` is the transparent
boundary: every mode has the same signature, so the model and training
loop never change when the comm stack is swapped. It is a thin façade
over the backend registry (:mod:`repro_torch.core.backends`) with no
per-mode branches. Ported modes: ``hadronio`` (pack -> ring-buffer
slices -> one collective per slice through its channel), ``sockets``
(one all-reduce per gradient tensor) and ``vma`` (one all-reduce of the
whole packed gradient); the others are ROADMAP.md Queue 1 item 4.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import CommConfig
from repro_torch.core.backends import SyncContext, SyncResult, get_backend
from repro_torch.core.channels import Ring

Tree = Any

__all__ = ["SyncResult", "sync_grads"]


def sync_grads(grads: Tree, comm: CommConfig, *, ring: Ring,
               ef: Optional[torch.Tensor] = None) -> SyncResult:
    """Sum this peer's gradients over ``ring`` with the strategy
    ``comm.mode`` names; ``ef`` is this peer's error-feedback residual.
    The signature — and so every call site — is the same for all
    modes."""
    ctx = SyncContext(comm, world_size=ring.world_size, rank=ring.rank,
                      ring=ring, ef=ef)
    return get_backend(comm.mode).sync(grads, ctx)
