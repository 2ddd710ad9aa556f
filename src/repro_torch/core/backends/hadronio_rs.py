"""``hadronio_rs`` — beyond the paper: per-slice reduce-scatter with a
data-sharded (ZeRO-1) optimizer. Each peer reduces and keeps 1/ring of
every ring slice, updates its flat parameter and moment shard, and
all-gathers the updated parameter slices back (one gather per slice).
``comm.aggregate="channel"`` coalesces each channel's slices into one
peer-major-interleaved reduce-scatter flush; the flat-shard layout is
the same (``pipeline.interleave_for_scatter``).

Counterpart of ``repro/core/backends/hadronio_rs.py``. The reference's
state carries a leading ring dim (``(n_shards, len)`` moments); each
process of the port holds its own row, ``(len,)``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import RunConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.backends import pipeline
from repro_torch.core.backends.base import (CommBackend, StateSpecs,
                                            SyncContext, SyncResult,
                                            UpdateContext, register,
                                            scatter_group_size)
from repro_torch.core.hierarchical import all_gather_data
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.optim.flat import (decay_runs, flat_adamw_update,
                                    mask_from_runs, reshard_ring_segments,
                                    shard_runs)

Tree = Any


def gather_updated(flat_shard: torch.Tensor, plan: agg.PackPlan,
                   like: Tree, gather_group) -> Tree:
    """The ZeRO-1 epilogue: all-gather every slice's updated shard over
    ``gather_group`` (one gather per slice, straight into its row of the
    packed vector) and unpack the vector into the tree, each leaf cast
    to ``like``'s dtype."""
    shard = flat_shard.view(plan.n_slices, -1)
    full = flat_shard.new_empty(plan.n_slices, plan.slice_elems)
    for i in range(plan.n_slices):
        all_gather_data(shard[i], gather_group, out=full[i])
    return agg.unpack(agg.from_slices(full, plan), plan, like)


def clip_shard(gsh: torch.Tensor, run: RunConfig, uctx: UpdateContext):
    """Clip this peer's gradient shard by the global norm of the whole
    flat gradient: the sum of squares all-reduced over the ring (each
    element lies in exactly one peer's shard). Returns (clipped shard,
    global norm)."""
    gn2 = gsh.square().sum()
    dist.all_reduce(gn2, group=uctx.ring.group)
    gn2 = gn2 / (uctx.ring.world_size // uctx.eff_shards)
    gnorm = gn2.sqrt()
    scale = torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    return gsh * scale, gnorm


@register("hadronio_rs")
class HadronioRsBackend(CommBackend):

    zero1 = True

    def sync(self, grads, ctx: SyncContext) -> SyncResult:
        plan = agg.make_plan(grads, ctx.comm, dtype=torch.float32)
        flat = agg.pack(grads, plan)
        slices = agg.as_slices(flat, plan)
        flat_shard, new_ef, gather_group = pipeline.scatter_slices(slices,
                                                                   ctx)
        return SyncResult(None, flat_shard, plan, new_ef, gather_group)

    def state_specs(self, run: RunConfig, n_shards: int = 1) -> StateSpecs:
        """This peer's flat ZeRO-1 moment shards, ``(padded / ring,)``,
        and its ring-keyed error feedback."""
        plan = agg.make_plan(api.specs(run.model), run.comm)
        meta = lambda shape: torch.empty(shape, dtype=torch.float32,
                                         device="meta")
        ef = meta((plan.n_slices, plan.slice_elems)) \
            if self.needs_ef(run.comm) else None
        eff = scatter_group_size(n_shards, 1, run.comm)
        if plan.padded_elems % eff:
            raise ValueError(f"{plan.padded_elems} packed elements do not "
                             f"shard over {eff} peers")
        shard = meta((plan.padded_elems // eff,))
        return StateSpecs(opt=adamw.AdamState(mu=shard, nu=shard, count=0),
                          ef=ef)

    def apply_update(self, params: Tree, opt: adamw.AdamState,
                     res: SyncResult, run: RunConfig, uctx: UpdateContext):
        """ZeRO-1: update this peer's flat parameter and moment shard
        (its chunk of every slice, the gradient shard's layout), then
        all-gather the updated parameter slices."""
        plan, eff = res.plan, uctx.eff_shards
        my = uctx.ring.rank
        nsl = plan.n_slices
        flat_p = agg.pack(params, plan)
        psl = flat_p.view(nsl, eff, -1)[:, my].reshape(-1)
        gsh, gnorm = clip_shard(res.flat_shard, run, uctx)
        dm = uctx.cached(
            ("hadronio_rs.decay", plan, eff, my, str(gsh.device)),
            lambda: mask_from_runs(
                shard_runs(decay_runs(plan), [plan.slice_elems] * nsl, eff,
                           my), gsh.numel(), gsh.device))
        count = opt.count + 1
        new_psl, new_mu, new_nu = flat_adamw_update(
            psl, gsh, opt.mu, opt.nu, count, dm, run)
        new_params = gather_updated(new_psl, plan, params, res.gather_group)
        return new_params, adamw.AdamState(new_mu, new_nu, count), \
            {"grad_norm": gnorm, "lr": adamw.schedule(run, count)}

    def gathered_grads(self, res: SyncResult, like: Tree) -> Tree:
        """The synced gradient tree from the ZeRO-1 shard (per-slice
        all-gather + unpack)."""
        return gather_updated(res.flat_shard, res.plan, like,
                              res.gather_group)

    def reshard_flat_shards(self, run: RunConfig, stacked, new_shards: int):
        """Elastic re-slice: the global flat layout is slice-major with
        ring-ordered chunks — n_slices equal segments."""
        plan = agg.make_plan(api.specs(run.model), run.comm)
        return reshard_ring_segments(stacked, stacked.shape[0], new_shards,
                                     [plan.slice_elems] * plan.n_slices)
