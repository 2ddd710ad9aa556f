"""AdamW on packed-flat vectors — the ZeRO-1 shard path.

Counterpart of ``repro/optim/flat.py``. The reduce-scatter backends
(``hadronio_rs``, ``hadronio_overlap_rs``) keep the optimizer moments as
flat, ring-sharded slices of the packed gradient vector; this module is
the flat-vector mirror of :mod:`repro_torch.optim.adamw` (same schedule,
same decoupled decay, the decay masked per element instead of per leaf).

The reference builds the mask inside the trace from fills of its
contiguous runs (``decay_mask_traced``), so that a 2 GB host constant
never enters the program. :func:`mask_from_runs` does the same on the
device, and :func:`shard_runs` maps the runs into one peer's shard, so a
backend builds only its own shard of the mask (once per plan and device:
``UpdateContext.cached``); :func:`decay_mask_flat` is the host (numpy)
mask, the reference's ``decay_mask_flat``.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import aggregation as agg
from repro_torch.optim import adamw


def decay_runs(plan: agg.PackPlan) -> list:
    """The contiguous ``(start, end)`` runs of decayed leaves (ndim >= 2,
    as ``adamw.update`` decays) in packed-flat element space; adjacent
    decayed leaves merge into one run."""
    runs, run_start, run_end = [], None, None
    for (start, end), shape in zip(plan.offsets, plan.shapes):
        if len(shape) >= 2:
            if run_start is None:
                run_start = start
            run_end = end
        elif run_start is not None:
            runs.append((run_start, run_end))
            run_start = None
    if run_start is not None:
        runs.append((run_start, run_end))
    return runs


def mask_from_runs(runs: Iterable, length: int,
                   device: torch.device) -> torch.Tensor:
    """A ``(length,)`` f32 mask on ``device``: ones over ``runs``, zeros
    elsewhere (the counterpart of the reference's in-trace fills)."""
    mask = torch.zeros(length, dtype=torch.float32, device=device)
    for s, e in runs:
        mask[s:e] = 1.0
    return mask


def shard_runs(runs: Iterable, seg_lens, group: int, my: int) -> list:
    """``runs`` of a global flat vector as they fall in peer ``my``'s
    ZeRO-1 shard. The global layout is segment-major (ring slices or
    buckets of ``seg_lens``), each segment carved into ``group``
    ring-ordered chunks; the shard is the peer's chunk of every segment,
    in segment order. So the shard of a mask is built without the mask."""
    runs = list(runs)
    out, base, off = [], 0, 0
    for L in seg_lens:
        c = L // group
        lo, hi = base + my * c, base + (my + 1) * c
        for s, e in runs:
            s, e = max(s, lo), min(e, hi)
            if s < e:
                out.append((off + s - lo, off + e - lo))
        base, off = base + L, off + c
    return out


def decay_mask_flat(plan: agg.PackPlan) -> np.ndarray:
    """Per-element weight-decay mask in packed-flat layout, on the host
    (decay only params with ndim >= 2, matching adamw.update)."""
    mask = np.zeros((plan.padded_elems,), np.float32)
    for s, e in decay_runs(plan):
        mask[s:e] = 1.0
    return mask


def decay_mask(plan: agg.PackPlan, device: torch.device) -> torch.Tensor:
    """:func:`decay_mask_flat`'s values, built on ``device`` from the
    runs (the reference's ``decay_mask_traced``)."""
    return mask_from_runs(decay_runs(plan), plan.padded_elems, device)


def reshard_ring_segments(stacked: np.ndarray, old_shards: int,
                          new_shards: int, seg_lens) -> np.ndarray:
    """Re-slice ring-sharded flat state for a new ring size (elastic
    restore). The global layout is segment-major: each segment (a ring
    slice or an overlap bucket) of global length ``L`` is carved into
    ``shards`` contiguous chunks in ring order, and each peer's row is
    the concatenation of its chunk of every segment. ``stacked``:
    (old_shards, sum(L)/old_shards). Returns (new_shards, ...)."""
    seg_lens = [int(L) for L in seg_lens]
    if stacked.shape != (old_shards, sum(seg_lens) // old_shards):
        raise ValueError(f"stacked {stacked.shape} is not ({old_shards}, "
                         f"{sum(seg_lens)} / {old_shards})")
    for L in seg_lens:
        if L % old_shards or L % new_shards:
            raise ValueError(f"segment of {L} elements does not shard over "
                             f"{old_shards} and {new_shards} peers")
    # rebuild each segment's global vector from the old chunks
    globs, off = [], 0
    for L in seg_lens:
        c = L // old_shards
        globs.append(np.concatenate([stacked[i, off:off + c]
                                     for i in range(old_shards)]))
        off += c
    return np.stack([
        np.concatenate([g[j * (len(g) // new_shards):
                          (j + 1) * (len(g) // new_shards)] for g in globs])
        for j in range(new_shards)])


def flat_adamw_update(flat_p: torch.Tensor, flat_g: torch.Tensor,
                      mu: torch.Tensor, nu: torch.Tensor, count: int,
                      decay_mask: torch.Tensor, run: RunConfig):
    """AdamW on flat f32 vectors; ``count`` is the update's number (the
    state's count + 1). Returns (new_p, new_mu, new_nu)."""
    b1, b2 = run.beta1, run.beta2
    lr = adamw.schedule(run, count)
    # bias corrections as f32 values, as adamw.update computes them
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** float(count))
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** float(count))
    mu = b1 * mu + (1 - b1) * flat_g
    nu = b2 * nu + (1 - b2) * flat_g.square()
    step = (mu / c1) / ((nu / c2).sqrt() + run.eps)
    step = step + run.weight_decay * decay_mask * flat_p
    return flat_p - lr * step, mu, nu
