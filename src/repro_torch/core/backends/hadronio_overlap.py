"""``hadronio_overlap`` — beyond the paper: DDP-style gradient bucketing.

The monolithic gathering write (``hadronio``) packs EVERY gradient leaf
before the first collective. This backend packs per-bucket subsets of
leaves instead, in reverse-layer order (the selector's
``emission_order``: backward produces the last layer's gradients
first), and stages each bucket with the channel emitter as soon as it is
packed, so under ``comm.flush="ready"`` a channel's coalesced collective
goes out the moment its last bucket is staged, before the later buckets
are packed.

Buckets fill greedily to ``comm.slice_bytes`` (one leaf larger than a
slice gets its own bucket) and are padded to the 512-element alignment.
Wire compression is supported: the error feedback is a tuple keyed by
bucket id (one residual per bucket, independent of the global ring
plan), so each bucket's pack stage stays self-contained.

Counterpart of ``repro/core/backends/hadronio_overlap.py``. As in the
reference, the buckets are exchanged after backward, in production
order; launching them from gradient hooks during backward is ROADMAP.md
Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import CommConfig, RunConfig
from repro_torch.core import compress as comp
from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, StateSpecs,
                                            SyncContext, SyncResult,
                                            register)
from repro_torch.core.selector import emission_order
from repro_torch.models import api
from repro_torch.models.common import tree_from_paths, tree_map, tree_paths
from repro_torch.optim import adamw

Tree = Any

ALIGN = 512   # matches aggregation.make_plan's reduce-scatter alignment


def make_buckets(sizes: list, slice_bytes: int,
                 itemsize: int = 4) -> list:
    """Greedy reverse-layer bucketing: leaf indices grouped so each bucket
    holds at most ``slice_bytes`` of wire payload (a single oversized leaf
    gets its own bucket). Bucket 0 holds the LAST leaves — the gradients
    backward produces first."""
    buckets: list = []
    cur: list = []
    cur_bytes = 0
    for i in emission_order(len(sizes), reverse=True):
        b = sizes[i] * itemsize
        if cur and cur_bytes + b > slice_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        buckets.append(cur)
    return buckets


class BucketPlan(NamedTuple):
    """Static layout of one bucketed exchange (the bucketed counterpart
    of ``aggregation.PackPlan``, from the leaves' shapes alone)."""
    buckets: tuple            # per bucket: tuple of leaf indices
    sizes: tuple              # per-leaf element counts (flatten order)
    shapes: tuple             # per-leaf shapes (flatten order)
    padded: tuple             # per-bucket padded element count
    align: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_padded(self) -> int:
        return sum(self.padded)


def make_bucket_plan(tree: Tree, comm: CommConfig,
                     align: int = ALIGN) -> BucketPlan:
    """The plan from the leaves' shapes (tensors or ``ParamSpec``s), in
    the reference's leaf order (``tree_paths``)."""
    shapes = tuple(tuple(leaf.shape) for _, leaf in tree_paths(tree))
    sizes = tuple(math.prod(s) for s in shapes)
    buckets = tuple(tuple(b) for b in make_buckets(list(sizes),
                                                   comm.slice_bytes))
    padded = tuple(-(-sum(sizes[i] for i in b) // align) * align
                   for b in buckets)
    return BucketPlan(buckets, sizes, shapes, padded, align)


def pack_bucket(leaves: list, plan: BucketPlan, b: int) -> torch.Tensor:
    """The per-bucket gathering write: the bucket's leaves copied, each
    cast to f32, into one zero-padded f32 vector."""
    flat = torch.empty(plan.padded[b], dtype=torch.float32,
                       device=leaves[0].device)
    off = 0
    for i in plan.buckets[b]:
        flat[off:off + plan.sizes[i]].copy_(leaves[i].reshape(-1))
        off += plan.sizes[i]
    flat[off:].zero_()
    return flat


def unpack_bucket(vec: torch.Tensor, plan: BucketPlan, b: int,
                  like_leaves: list, out: list) -> None:
    """The inverse carve of one bucket into ``out`` (a per-leaf slot
    list), each leaf cast to its ``like`` dtype."""
    off = 0
    for i in plan.buckets[b]:
        out[i] = vec[off:off + plan.sizes[i]].view(plan.shapes[i]).to(
            like_leaves[i].dtype)
        off += plan.sizes[i]


def bucket_ef_specs(plan: BucketPlan) -> tuple:
    """Per-bucket error-feedback layout, keyed by bucket id: this peer's
    ``(padded_b,)`` f32 residual per bucket, as ``meta`` tensors (the
    reference's leaves carry a leading ring dim)."""
    return tuple(torch.empty((p,), dtype=torch.float32, device="meta")
                 for p in plan.padded)


def _bucket_efs(plan: BucketPlan, ctx: SyncContext) -> list:
    efs = list(ctx.ef) if ctx.ef is not None else [None] * plan.n_buckets
    if len(efs) != plan.n_buckets:
        raise ValueError(f"{len(efs)} error-feedback residuals for "
                         f"{plan.n_buckets} buckets")
    return efs


def pack_buckets_wire(leaves: list, plan: BucketPlan, ctx: SyncContext):
    """The pack stage per bucket. Returns (wires, new_efs, scales), lists
    indexed by bucket id: wires ``(1, padded_b)`` of the wire dtype,
    new_efs ``(padded_b,)`` f32 or None."""
    wires, new_efs, scales = [], [], []
    for b, ef in enumerate(_bucket_efs(plan, ctx)):
        wire, nef, scale = pipeline.pack_wire(
            pack_bucket(leaves, plan, b)[None],
            None if ef is None else ef[None], ctx.comm)
        wires.append(wire)
        new_efs.append(None if nef is None else nef[0])
        scales.append(scale)
    return wires, new_efs, scales


def stage_buckets(leaves: list, plan: BucketPlan, ctx: SyncContext,
                  kind: str, *, group: int = 1):
    """The readiness-driven gathering write: pack each bucket and stage
    it with the channel emitter IN PRODUCTION ORDER (bucket 0 holds the
    gradients backward produces first), so under ``comm.flush="ready"``
    each channel's coalesced collective is issued the moment its last
    bucket is staged, before later buckets are packed. The unpack stage
    runs per flush, once the flush's collective has completed. Returns
    ``(per-bucket f32 results, new_efs)``."""
    st = pipeline.begin_emission(ctx, plan.n_buckets, kind, group=group,
                                 unpack=True)
    new_efs = []
    for b, ef in enumerate(_bucket_efs(plan, ctx)):
        wire, nef, scale = pipeline.pack_wire(
            pack_bucket(leaves, plan, b)[None],
            None if ef is None else ef[None], ctx.comm)
        if scale is not None:
            raise ValueError("int8 wires are summed by int8_allreduce, "
                             "not through the channel emitter")
        new_efs.append(None if nef is None else nef[0])
        pipeline.stage_slices(st, b, wire)
    return pipeline.finish_emission(st), new_efs


def bucket_ef_result(new_efs: list):
    return tuple(new_efs) if any(e is not None for e in new_efs) else None


def ready_serve_emit(flat, ctx: SyncContext, kind: str):
    """The overlap strategies' serving wire: always flush when ready (a
    serving payload's slices are staged in production order and each
    channel's coalesced collective goes out the moment its run is
    complete — hadroNIO's flush-on-writable on the latency-critical
    path). Only the emission differs; the values are the same."""
    rctx = dataclasses.replace(
        ctx, comm=dataclasses.replace(ctx.comm, flush="ready"))
    return pipeline.emit_flat(flat, rctx, kind)


@register("hadronio_overlap")
class HadronioOverlapBackend(CommBackend):

    def state_specs(self, run: RunConfig, n_shards: int = 1,
                    pod_size: int = 1) -> StateSpecs:
        """Tree moments (DDP-style), plus per-bucket error feedback when
        compression is on, keyed by bucket id (this mode never builds a
        ring plan)."""
        specs = api.specs(run.model)
        moments = lambda: tree_map(lambda s: torch.empty(
            s.shape, dtype=torch.float32, device="meta"), specs)
        ef = bucket_ef_specs(make_bucket_plan(specs, run.comm)) \
            if self.needs_ef(run.comm) else None
        return StateSpecs(opt=adamw.AdamState(mu=moments(), nu=moments(),
                                              count=0), ef=ef)

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        paths = tree_paths(grads)
        leaves = [leaf for _, leaf in paths]
        plan = make_bucket_plan(grads, ctx.comm)
        if ctx.comm.compress == "int8_ef":
            # per-bucket all-gather + local dequant-sum
            wires, new_efs, scales = pack_buckets_wire(leaves, plan, ctx)
            reduced = [comp.int8_allreduce(q, s, ctx.ring.group)
                       for q, s in zip(wires, scales)]
        else:
            reduced, new_efs = stage_buckets(leaves, plan, ctx, "all_reduce")
        out: list = [None] * len(leaves)
        for b, red in enumerate(reduced):
            unpack_bucket(red.reshape(-1), plan, b, leaves, out)
        synced = tree_from_paths((p, o) for (p, _), o in zip(paths, out))
        return SyncResult(synced, plan=plan, ef=bucket_ef_result(new_efs))

    def serve_emit(self, flat, ctx, kind):
        return ready_serve_emit(flat, ctx, kind)
