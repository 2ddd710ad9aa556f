"""``sockets`` — the plain-sockets baseline (the paper's comparison
point): one all-reduce per gradient tensor. Per-buffer sends, a fixed
cost paid per tensor; no aggregation, no plan, no packing. The
all-reduces are issued asynchronously on the ring's group and waited on
in issue order. They sum the gradient tensors IN PLACE: the synced tree
is the tree passed in (the train step's fresh autograd gradients).

Counterpart of ``repro/core/backends/sockets.py``.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.configs.base import CommConfig
from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, SyncContext,
                                            SyncResult, register)
from repro_torch.models.common import tree_paths


@register("sockets")
class SocketsBackend(CommBackend):

    def needs_ef(self, comm: CommConfig) -> bool:
        return False

    def validate(self, comm: CommConfig) -> None:
        if comm.compress != "none":
            raise ValueError(
                "sockets cannot honor wire compression "
                f"(compress={comm.compress!r}): each tensor is summed "
                "unpacked — there is no wire stage to compress; use a "
                "hadronio-family mode")

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        self.validate(ctx.comm)
        works = [dist.all_reduce(g, group=ctx.ring.group, async_op=True)
                 for _, g in tree_paths(grads)]
        for work in works:
            work.wait()
        return SyncResult(grads)

    def serve_emit(self, flat, ctx, kind):
        """Per-buffer serving sends: one unsliced collective per payload,
        no aggregation."""
        return pipeline.raw_emit(flat, ctx, kind)
