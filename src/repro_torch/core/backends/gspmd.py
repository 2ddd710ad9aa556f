"""``gspmd`` — the reference serving path: one whole-payload collective
per emission, no ring-buffer slicing, no channel pool.

Counterpart of ``repro/core/backends/gspmd.py``, whose ``serve_emit``
is ``pipeline.raw_emit``. At ring size 1 every serving kind returns the
payload itself (a sum over one peer, a gather of one peer's block); a
wider ring needs the ``torch.distributed`` group of the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.backends.base import (SERVE_KINDS, CommBackend,
                                            SyncContext, register)


def raw_emit(flat: torch.Tensor, ctx: SyncContext, kind: str) -> torch.Tensor:
    """The unsliced serving emission (``pipeline.raw_emit``)."""
    if kind not in SERVE_KINDS:
        raise ValueError(f"unknown serving kind {kind!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"serving over a ring of {ctx.world_size} peers needs the "
            "torch.distributed group of the training slice (ROADMAP.md, "
            "Queue 1: 'The comm core')")
    return flat


@register("gspmd")
class GspmdBackend(CommBackend):

    def serve_emit(self, flat, ctx, kind):
        return raw_emit(flat, ctx, kind)
