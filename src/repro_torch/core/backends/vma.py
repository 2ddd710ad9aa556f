"""``vma`` — the libvma analogue: one monolithic all-reduce of the whole
packed gradient. Fewest collectives, but nothing to overlap and a
full-size staging copy (the pack materialises every gradient before the
single send).

Counterpart of ``repro/core/backends/vma.py``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import CommConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, SyncContext,
                                            SyncResult, register)


@register("vma")
class VmaBackend(CommBackend):

    def validate(self, comm: CommConfig) -> None:
        if comm.compress == "int8_ef":
            raise ValueError(
                "vma cannot honor compress='int8_ef': the libvma analogue "
                "is one monolithic all-reduce, and int8 summation needs "
                "the gather + local-dequant exchange of the hadronio "
                "family")

    def needs_ef(self, comm: CommConfig) -> bool:
        return comm.compress == "bf16"

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        self.validate(ctx.comm)
        plan = agg.make_plan(grads, ctx.comm, dtype=torch.float32)
        flat = agg.pack(grads, plan)
        if ctx.comm.compress == "bf16":
            # the pack stage over the ring-slice view (its EF layout is the
            # state spec's); the wire is still ONE all-reduce, and the
            # unpack stage casts back to f32
            wire, new_ef, _ = pipeline.pack_wire(agg.as_slices(flat, plan),
                                                 ctx.ef, ctx.comm)
            dist.all_reduce(wire, group=ctx.ring.group)
            red = pipeline.unpack_wire(wire, ctx.comm)
            synced = agg.unpack(agg.from_slices(red, plan), plan, grads)
            return SyncResult(synced, plan=plan, ef=new_ef)
        dist.all_reduce(flat, group=ctx.ring.group)
        return SyncResult(agg.unpack(flat, plan, grads), plan=plan)

    def serve_emit(self, flat, ctx, kind):
        """Monolithic serving send: the payload arrives flat, so the one
        big all-reduce IS the unsliced whole-payload collective (the same
        as sockets for a single buffer)."""
        return pipeline.raw_emit(flat, ctx, kind)
