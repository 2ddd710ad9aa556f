"""``hadronio`` — the paper-faithful gathering write (§III-C): pack the
gradient tree into ring-buffer slices, then one collective per slice,
each issued on its channel's own communicator (the
worker-per-connection analogue), all in flight together.
``comm.aggregate="channel"`` raises the flush granularity to one
coalesced buffer per channel, with bit-identical results (see
``pipeline.emit_through_channels``).

Counterpart of ``repro/core/backends/hadronio.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, SyncContext,
                                            SyncResult, register)


@register("hadronio")
class HadronioBackend(CommBackend):

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        plan = agg.make_plan(grads, ctx.comm, dtype=torch.float32)
        # the packed f32 vector lives through the pack stage alone: the
        # emission and the unpack hold only the wire and the residual
        wire, new_ef, scale = pipeline.pack_wire(
            agg.as_slices(agg.pack(grads, plan), plan), ctx.ef, ctx.comm)
        red = pipeline.reduce_wire(wire, scale, ctx)
        del wire
        synced = agg.unpack(agg.from_slices(red, plan), plan, grads)
        return SyncResult(synced, plan=plan, ef=new_ef)
