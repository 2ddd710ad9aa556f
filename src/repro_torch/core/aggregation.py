"""Gathering-write aggregation (paper §III-C) on gradient trees.

Counterpart of ``repro/core/aggregation.py``. netty hands hadroNIO an
array of buffers and hadroNIO merges them into one contiguous
ring-buffer region, so one request sends what used to be N. Here the
gradient tree is packed into one contiguous f32 vector (the merge),
carved into ring-buffer slices, and each slice becomes one collective.

The leaf order is the reference's: dict keys sorted at every level
(``models.common.tree_paths``, the order ``jax.tree.leaves`` gives). It
matters beyond tidiness: an error-feedback residual carried over from
JAX is keyed to positions in this flat vector.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import CommConfig
from repro_torch.core.ring_buffer import SlicePlan, plan_slices
from repro_torch.models.common import tree_from_paths, tree_paths

Tree = Any


class PackPlan(NamedTuple):
    offsets: tuple            # per-leaf (start, end) in flat element space
    shapes: tuple             # per-leaf shapes
    total_elems: int
    padded_elems: int         # n_slices * slice_elems
    slice_elems: int
    n_slices: int
    slice_plan: SlicePlan
    dtype: torch.dtype


def make_plan(tree: Tree, comm: CommConfig,
              dtype: torch.dtype = torch.float32) -> PackPlan:
    """The plan from the leaves' shapes alone (tensors, or anything with
    a ``shape``, such as a ``ParamSpec`` tree)."""
    shapes = tuple(tuple(leaf.shape) for _, leaf in tree_paths(tree))
    sizes = [math.prod(s) for s in shapes]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + n)
    total = starts[-1]
    itemsize = torch.empty((), dtype=dtype).element_size()
    sp = plan_slices(total * itemsize, comm)
    # slices are 512-element aligned (even reduce-scatter shards for any
    # ring of up to 512 peers)
    slice_elems = max(512, sp.slice_bytes // itemsize)
    slice_elems = -(-slice_elems // 512) * 512
    n_slices = max(1, -(-total // slice_elems))
    return PackPlan(
        offsets=tuple((starts[i], starts[i + 1]) for i in range(len(sizes))),
        shapes=shapes,
        total_elems=total,
        padded_elems=n_slices * slice_elems,
        slice_elems=slice_elems,
        n_slices=n_slices,
        slice_plan=sp,
        dtype=dtype,
    )


def pack(tree: Tree, plan: PackPlan) -> torch.Tensor:
    """Merge all leaves into one contiguous zero-padded vector of
    ``plan.dtype`` (the gathering write). Each leaf is cast as it is
    copied into place, so no concatenated temporary is made."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    first = leaves[0]
    flat = torch.empty(plan.padded_elems, dtype=plan.dtype,
                       device=first.device)
    for (start, end), leaf in zip(plan.offsets, leaves):
        flat[start:end].copy_(leaf.reshape(-1))
    flat[plan.total_elems:].zero_()
    return flat


def unpack(flat: torch.Tensor, plan: PackPlan, like: Tree) -> Tree:
    """Inverse of :func:`pack`: carve the vector back into the tree,
    each leaf cast to the dtype of ``like``'s leaf (a leaf already in
    that dtype is a view of ``flat``)."""
    out = []
    for ((path, ref), (start, end), shape) in zip(tree_paths(like),
                                                  plan.offsets, plan.shapes):
        out.append((path, flat[start:end].view(shape).to(ref.dtype)))
    return tree_from_paths(out)


def as_slices(flat: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    """(padded_elems,) -> (n_slices, slice_elems) ring-buffer view."""
    return flat.view(plan.n_slices, plan.slice_elems)


def from_slices(slices: torch.Tensor, plan: PackPlan) -> torch.Tensor:
    return slices.reshape(plan.padded_elems)
