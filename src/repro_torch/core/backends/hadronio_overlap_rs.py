"""``hadronio_overlap_rs`` — beyond the paper: bucketed ZeRO-1.

``hadronio_overlap``'s reverse-layer bucketing (each bucket staged with
the channel emitter as soon as it is packed) composed with
``hadronio_rs``'s reduce-scatter and flat-shard AdamW update
(``optim/flat.py``): each bucket reduce-scatters its OWN shard.

Layout: the peer's flat shard is the concatenation, in bucket order, of
its contiguous chunk of every bucket (chunk = padded_b / group). Buckets
are padded to lcm(512, group) so that every bucket shards evenly. The
error feedback is keyed by bucket id, as in ``hadronio_overlap``.

Counterpart of ``repro/core/backends/hadronio_overlap_rs.py``. Each
process holds its own row of the reference's ``(n_shards, len)`` flat
moments.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import CommConfig, RunConfig
from repro_torch.core import compress as comp
from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, StateSpecs,
                                            SyncContext, SyncResult,
                                            UpdateContext, register,
                                            scatter_group_size)
from repro_torch.core.backends.hadronio_overlap import (
    ALIGN, BucketPlan, bucket_ef_result, bucket_ef_specs, make_bucket_plan,
    pack_bucket, pack_buckets_wire, ready_serve_emit, stage_buckets,
    unpack_bucket)
from repro_torch.core.backends.hadronio_rs import clip_shard
from repro_torch.core.flush_scheduler import make_flush_plan
from repro_torch.core.hierarchical import all_gather_data
from repro_torch.models import api
from repro_torch.models.common import tree_from_paths, tree_paths
from repro_torch.optim import adamw
from repro_torch.optim.flat import (flat_adamw_update, mask_from_runs,
                                    reshard_ring_segments, shard_runs)

Tree = Any


def rs_align(group: int) -> int:
    """Bucket padding alignment: every bucket must shard evenly over the
    scatter group AND keep the 512-lane alignment -> lcm."""
    return ALIGN * group // math.gcd(ALIGN, group)


def rs_bucket_plan(tree: Tree, comm: CommConfig, group: int) -> BucketPlan:
    return make_bucket_plan(tree, comm, align=rs_align(group))


def bucket_decay_runs(plan: BucketPlan) -> list:
    """The contiguous ``(start, end)`` runs of decayed leaves (ndim >= 2,
    as ``adamw.update`` decays) in the bucketed flat layout; a run never
    crosses a bucket's padding."""
    runs, base = [], 0
    for b, idx in enumerate(plan.buckets):
        off, run_start = base, None
        for i in idx:
            if len(plan.shapes[i]) >= 2:
                if run_start is None:
                    run_start = off
                run_end = off + plan.sizes[i]
            elif run_start is not None:
                runs.append((run_start, run_end))
                run_start = None
            off += plan.sizes[i]
        if run_start is not None:
            runs.append((run_start, run_end))
        base += plan.padded[b]
    return runs


def bucket_decay_mask(plan: BucketPlan,
                      device: torch.device) -> torch.Tensor:
    """The per-element weight-decay mask in bucketed flat layout, built
    on ``device`` from its runs (the reference's in-trace fills)."""
    return mask_from_runs(bucket_decay_runs(plan), plan.total_padded, device)


def gather_flush_groups(plan: BucketPlan, comm: CommConfig) -> tuple:
    """Bucket ids per all-gather of the ZeRO-1 update epilogue. Under the
    flush-when-ready channel schedule the epilogue mirrors the sync's
    flushes: the ready groups are contiguous bucket runs, so each
    flush's chunk is contiguous in the flat-shard layout and one gather
    per flush returns the bytes of one gather per bucket (n_channels
    epilogue collectives instead of n_buckets). Every other schedule
    keeps one gather per bucket."""
    if comm.aggregate == "channel" and comm.flush == "ready":
        fp = make_flush_plan(plan.n_buckets, comm.channels, "ready")
        if fp.contiguous:
            return fp.groups
    return tuple((b,) for b in range(plan.n_buckets))


def shard_of_buckets(vectors_by_bucket, plan: BucketPlan, group: int,
                     my: int) -> torch.Tensor:
    """This peer's contiguous chunk of every bucket vector, concatenated
    in bucket order — the flat-shard layout."""
    parts = []
    for b, vec in enumerate(vectors_by_bucket):
        c = plan.padded[b] // group
        parts.append(vec[my * c:(my + 1) * c])
    return torch.cat(parts)


@register("hadronio_overlap_rs")
class HadronioOverlapRsBackend(CommBackend):

    zero1 = True

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        leaves = [leaf for _, leaf in tree_paths(grads)]
        gather_group, group = pipeline.scatter_group(ctx)
        plan = rs_bucket_plan(grads, ctx.comm, group)
        if ctx.comm.compress == "int8_ef":
            # per-bucket dequant-sum everywhere, keep this peer's chunk
            wires, new_efs, scales = pack_buckets_wire(leaves, plan, ctx)
            shards = shard_of_buckets(
                [comp.int8_allreduce(q, s, ctx.ring.group).reshape(-1)
                 for q, s in zip(wires, scales)], plan, group, ctx.rank % group)
        else:
            # staged per-bucket reduce-scatter through the channel
            # schedule, unpacked per flush
            reduced, new_efs = stage_buckets(leaves, plan, ctx,
                                             "reduce_scatter", group=group)
            shards = torch.cat([r.reshape(-1) for r in reduced])
        return SyncResult(None, shards, plan, bucket_ef_result(new_efs),
                          gather_group)

    def serve_emit(self, flat, ctx, kind):
        return ready_serve_emit(flat, ctx, kind)

    def state_specs(self, run: RunConfig, n_shards: int = 1,
                    pod_size: int = 1) -> StateSpecs:
        """This peer's flat ZeRO-1 moment shards in bucketed layout,
        ``(total_padded / group,)`` (the scatter group: in-pod under
        hierarchical collectives over pods), and per-bucket error
        feedback."""
        specs = api.specs(run.model)
        eff = scatter_group_size(n_shards, pod_size, run.comm)
        plan = rs_bucket_plan(specs, run.comm, eff)
        ef = bucket_ef_specs(plan) if self.needs_ef(run.comm) else None
        shard = torch.empty((plan.total_padded // eff,), dtype=torch.float32,
                            device="meta")
        return StateSpecs(opt=adamw.AdamState(mu=shard, nu=shard, count=0),
                          ef=ef)

    def apply_update(self, params: Tree, opt: adamw.AdamState,
                     res: SyncResult, run: RunConfig, uctx: UpdateContext):
        """Bucketed ZeRO-1: update this peer's flat parameter and moment
        shard, then all-gather the updated parameters, one gather per
        epilogue group (:func:`gather_flush_groups`). With hierarchical
        collectives over pods the shard index is in-pod."""
        plan: BucketPlan = res.plan
        eff, my = uctx.eff_shards, uctx.shard_index
        paths = tree_paths(params)
        leaves_p = [leaf for _, leaf in paths]
        psl = shard_of_buckets(
            [pack_bucket(leaves_p, plan, b) for b in range(plan.n_buckets)],
            plan, eff, my)
        gsh, gnorm = clip_shard(res.flat_shard, run, uctx)
        dm = uctx.cached(
            ("hadronio_overlap_rs.decay", plan, eff, my, str(gsh.device)),
            lambda: mask_from_runs(
                shard_runs(bucket_decay_runs(plan), plan.padded, eff, my),
                gsh.numel(), gsh.device))
        count = opt.count + 1
        new_psl, new_mu, new_nu = flat_adamw_update(
            psl, gsh, opt.mu, opt.nu, count, dm, run)
        out: list = [None] * len(leaves_p)
        off = 0
        for grp in gather_flush_groups(plan, run.comm):
            glen = sum(plan.padded[b] // eff for b in grp)
            mat = all_gather_data(new_psl[off:off + glen],
                                  res.gather_group).view(eff, glen)
            coff = 0
            for b in grp:
                c = plan.padded[b] // eff
                unpack_bucket(mat[:, coff:coff + c].reshape(-1), plan, b,
                              leaves_p, out)
                coff += c
            off += glen
        new_params = tree_from_paths((p, o) for (p, _), o in zip(paths, out))
        return new_params, adamw.AdamState(new_mu, new_nu, count), \
            {"grad_norm": gnorm, "lr": adamw.schedule(run, count)}

    def gathered_grads(self, res: SyncResult, like: Tree) -> Tree:
        """The synced gradient tree: a per-bucket all-gather of the shard
        chunks, then the inverse carve."""
        plan: BucketPlan = res.plan
        paths = tree_paths(like)
        like_leaves = [leaf for _, leaf in paths]
        out: list = [None] * len(like_leaves)
        group = plan.total_padded // res.flat_shard.numel()
        off = 0
        for b in range(plan.n_buckets):
            c = plan.padded[b] // group
            full_b = all_gather_data(res.flat_shard[off:off + c],
                                     res.gather_group)
            unpack_bucket(full_b, plan, b, like_leaves, out)
            off += c
        return tree_from_paths((p, o) for (p, _), o in zip(paths, out))

    def reshard_flat_shards(self, run: RunConfig, stacked, new_shards: int):
        """Elastic re-slice of the bucketed flat moments. When the bucket
        plan is the same for both ring sizes (the scatter group divides
        the 512 alignment for both: the power-of-two case) the old values
        are re-sliced exactly. Another group changes the lcm(512, group)
        bucket padding itself, so the old flat layout has no
        element-preserving mapping: the plan is rebuilt at the new
        alignment and the flat moments start again from zero (AdamW warms
        them back up over ~1/(1-beta) steps; the parameters are
        replicated and untouched)."""
        specs = api.specs(run.model)
        old_shards = stacked.shape[0]
        eff_old = scatter_group_size(old_shards, 1, run.comm)
        eff_new = scatter_group_size(new_shards, 1, run.comm)
        if rs_align(eff_old) != rs_align(eff_new):
            plan = rs_bucket_plan(specs, run.comm, eff_new)
            return np.zeros((new_shards, plan.total_padded // eff_new),
                            np.float32)
        plan = rs_bucket_plan(specs, run.comm, eff_old)
        return reshard_ring_segments(stacked, old_shards, new_shards,
                                     plan.padded)
