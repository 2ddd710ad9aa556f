"""``gspmd`` — the reference path without a manual exchange: in JAX,
XLA's GSPMD owns every collective. In the port (``manual=False``:
``sync`` is never called) it trains over a ``DeviceMesh`` with DTensor's
sharding propagation owning every collective
(``launch/steps.make_train_step_gspmd``), and one peer with local
gradients and a tree AdamW, which makes it the yardstick for what the
hadronio exchange costs per step on the card.

Serving: one whole-payload collective per emission on the ring's
group, no ring-buffer slicing, no channel pool (``pipeline.raw_emit``).
At ring size 1 with no channel affinity the serve step runs the pure
local path and emits nothing (``serving/dispatch``), as in the
reference.

Counterpart of ``repro/core/backends/gspmd.py``.
"""
from __future__ import annotations

from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, SyncContext,
                                            SyncResult, register)


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
        return pipeline.raw_emit(flat, ctx, kind)
