"""``gspmd`` — the reference path without a manual exchange: in JAX,
XLA's GSPMD owns every collective. In the port it trains one peer with
local gradients and a tree AdamW (``manual=False``: ``sync`` is never
called), which makes it the yardstick for what the hadronio exchange
costs per step on the card. A ring of more than one peer needs FSDP2 /
DTensor (ROADMAP.md Queue 1 item 8); ``launch/steps`` raises for it.

Serving: one whole-payload collective per emission, no ring-buffer
slicing, no channel pool (``pipeline.raw_emit`` in the reference). At
ring size 1 every serving kind returns the payload itself.

Counterpart of ``repro/core/backends/gspmd.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.backends.base import (SERVE_KINDS, CommBackend,
                                            SyncContext, SyncResult,
                                            register)


def raw_emit(flat: torch.Tensor, ctx: SyncContext, kind: str) -> torch.Tensor:
    """The unsliced serving emission (``pipeline.raw_emit``)."""
    if kind not in SERVE_KINDS:
        raise ValueError(f"unknown serving kind {kind!r}")
    if ctx.world_size != 1:
        raise NotImplementedError(
            f"serving over a ring of {ctx.world_size} peers is not ported "
            "yet (ROADMAP.md Queue 1 item 3: 'Serving at ring size > 1')")
    return flat


@register("gspmd")
class GspmdBackend(CommBackend):

    manual = False

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        raise RuntimeError(
            "gspmd mode has no explicit gradient exchange; sync_grads "
            "must not be called")

    def needs_ef(self, comm) -> bool:
        # no manual wire -> no compression, so the inherited state_specs
        # default yields tree moments with ef=None
        return False

    def validate(self, comm) -> None:
        if comm.compress != "none":
            raise ValueError(
                "gspmd cannot honor wire compression "
                f"(compress={comm.compress!r}): it has no manual wire "
                "stage; use a TAC mode")

    def serve_emit(self, flat, ctx, kind):
        return raw_emit(flat, ctx, kind)
