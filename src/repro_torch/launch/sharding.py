"""Logical-axis -> mesh-axis sharding rules with divisibility fallback,
and their DTensor placements.

Counterpart of ``repro/launch/sharding.py``, with its rule tables, its
fallbacks and its arguments. Parameters carry logical axes on their
ParamSpecs; activations name their axes at ``shard_fn`` call sites. The
rules map logical names to mesh axes; a dim that is not divisible by the
target axis size falls back to replicated (e.g. qwen1.5-4b's 20 heads on
a 16-way model axis).

Parallelism coverage: TP = heads/mlp/vocab/experts/lru over ``model``;
FSDP = embed dims over ``data``; DP = batch over (pod, data); SP = seq
over ``model``; EP = experts over ``model``.

The rules are pure functions of a mesh's axis names and sizes, so they
take a device-free ``launch/mesh.Mesh`` or a ``DeviceMesh`` alike.
:func:`spec_partition` returns the reference's per-dim partition (a
tuple of ``None``, an axis name or a tuple of axis names: its
``PartitionSpec`` as a tuple); :class:`Sharding` pairs a mesh with one
(the reference's ``NamedSharding``, ``.spec``). :func:`placements` turns
a partition into DTensor placements over the mesh's dims: ``Shard(d)``
on each mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere.
A dim named by a tuple of axes is split over them in mesh order (the
reference's ``P(("pod", "data"))`` is pod-major); a tuple in another
order has no DTensor form and raises.

Where the reference lets XLA's GSPMD own every collective, the port lets
DTensor's sharding propagation own them: :func:`make_shard_fn`'s
constraints are ``redistribute`` calls, and the ops between them run on
DTensors. :func:`distribute` places a full tensor by taking this rank's
block of it locally (no collective): every peer holds the same full
value, as every host of the reference holds the global arrays it
``device_put``s; :func:`distribute_tree` places a whole tree (a cache
at :func:`cache_shardings`, as ``steps.distribute_state`` places the
train state).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.common import ParamSpec, tree_map
from repro_torch.models.layers import no_shard

Tree = Any

# logical axis -> candidate mesh axes, tried in order
PARAM_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "lru": ("model",),
    "lru_blocks": ("model",),
    "embed": ("data",),       # FSDP
    "frames": (),
    "seq": (),
    "layers": (),
}

ACT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"),),
    "seq": ("model",),
    "seq_model": ("model",),    # decode KV length (flash-decoding layout)
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "lru": ("model",),
    "experts": ("model",),
    "expert_cap": ("data",),
    "seq_kv": ("data",),
}


def _resolve(mesh, rules: dict, logical: Optional[str], dim: int,
             used: set, *, fsdp: bool = True):
    """Pick a mesh axis (or axis tuple) for one dim, or None."""
    if logical is None or logical not in rules:
        return None
    if logical == "embed" and not fsdp:
        return None
    shape = mesh_shape(mesh)
    for cand in rules[logical]:
        names = (cand,) if isinstance(cand, str) else tuple(cand)
        # drop axes not present in this mesh (e.g. 'pod' on single pod)
        names = tuple(a for a in names if a in shape)
        if not names:
            continue
        size = math.prod(shape[a] for a in names)
        if size <= 1 or dim % size != 0:
            continue
        if any(a in used for a in names):
            continue
        used.update(names)
        return names if len(names) > 1 else names[0]
    return None


def spec_partition(mesh, spec: ParamSpec, *, fsdp: bool = True) -> tuple:
    used: set = set()
    return tuple(_resolve(mesh, PARAM_RULES, ax, dim, used, fsdp=fsdp)
                 for dim, ax in zip(spec.shape, spec.axes))


@dataclass(frozen=True)
class Sharding:
    """A mesh and a per-dim partition: the reference's
    ``NamedSharding(mesh, P(*spec))``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, partition: tuple) -> tuple:
    """DTensor placements of ``partition`` over ``mesh``'s dims."""
    names = tuple(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(partition):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {d} is split over {axes}, against the mesh's order "
                f"{names}: DTensor splits a dim over mesh dims in mesh "
                "order only")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def param_shardings(mesh, specs: Tree, *, fsdp: bool = True) -> Tree:
    return tree_map(lambda s: Sharding(mesh, spec_partition(mesh, s,
                                                            fsdp=fsdp)),
                    specs)


def block_slices(shape: tuple, mesh, pls: tuple) -> tuple:
    """The index of this rank's block of a global array of ``shape``
    under ``pls`` (each sharded dim divides evenly, as the rules
    guarantee). Mesh dims that shard the same dim nest in mesh order,
    as DTensor lays them out. Works on tensors and numpy arrays."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    lo, size = [0] * len(shape), list(shape)
    for i, p in enumerate(pls):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(i)
        if size[p.dim] % n:
            raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                             f"split evenly over {n} peers")
        size[p.dim] //= n
        lo[p.dim] += coord[i] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def distribute(full: torch.Tensor, sharding: Sharding) -> DTensor:
    """``full`` (the same value on every rank) as a DTensor at
    ``sharding``: this rank's block, copied, with no collective."""
    pls = sharding.placements
    local = full[block_slices(full.shape, sharding.mesh, pls)].clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, pls, run_check=False)


def distribute_tree(tree: Tree, shardings: Tree) -> Tree:
    """Every full tensor of ``tree`` (the same on every peer) placed at
    its leaf of ``shardings`` (:func:`distribute`): a cache tree at
    :func:`cache_shardings`, params at :func:`param_shardings`, inputs
    at :func:`batch_sharding`."""
    return tree_map(distribute, tree, shardings)


def act_partition(mesh, shape: tuple, logical: tuple, *,
                  manual_axes: tuple = (), sp_explicit: bool = False,
                  no_sp: bool = False) -> Optional[tuple]:
    """The partition :func:`make_shard_fn`'s constraint pins an
    activation of ``shape`` to, or None where the reference leaves it
    unconstrained (every dim resolves to None with no ``"rep"`` pin, or
    a ``seq_gather`` site without ``sp_explicit``)."""
    if "seq_gather" in logical:
        if not sp_explicit:
            return None
        used: set = set(manual_axes)
        return tuple(_resolve(mesh, ACT_RULES, "batch", shape[i], used)
                     if ax == "batch" else None
                     for i, ax in enumerate(logical))
    used = set(manual_axes)
    parts = []
    force = False
    for dim, ax in zip(shape, logical):
        if ax == "rep":               # explicit replication pin
            force = True
            parts.append(None)
            continue
        if no_sp and ax == "seq":     # TP all-reduce, no seq shard
            parts.append(None)
            continue
        parts.append(_resolve(mesh, ACT_RULES, ax, dim, used))
    if not force and all(p is None for p in parts):
        return None
    return tuple(parts)


def make_shard_fn(mesh, *, manual_axes: tuple = (),
                  sp_explicit: bool | None = None):
    """Activation-constraint function threaded through model code.

    On a DTensor it ``redistribute``s to the constraint's placements
    (:func:`act_partition`; ``"rep"`` pins ``Replicate``); a site the
    reference leaves unconstrained returns it as it is, and so does a
    plain tensor.

    ``manual_axes``: axes already manual; constraints do not mention
    them.

    ``sp_explicit`` (default from env ``REPRO_SP_EXPLICIT``): Megatron-SP
    transition pinning: the ``seq_gather`` logical axis becomes an
    explicit *replicated* constraint, so each block gathers the sequence
    once before its projections and reduce-scatters it once at the
    residual. ``REPRO_NO_SP=1`` drops the seq sharding (TP all-reduce).
    """
    if mesh is None:
        return no_shard
    if sp_explicit is None:
        sp_explicit = os.environ.get("REPRO_SP_EXPLICIT", "") == "1"
    no_sp = os.environ.get("REPRO_NO_SP", "") == "1"

    def shard_fn(x, logical):
        if not isinstance(x, DTensor):
            return x
        part = act_partition(mesh, tuple(x.shape), logical,
                             manual_axes=manual_axes,
                             sp_explicit=sp_explicit, no_sp=no_sp)
        if part is None:
            return x
        return x.redistribute(mesh, placements(mesh, part))

    return shard_fn


def _dp(mesh) -> tuple:
    shape = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in shape)
    return dp, math.prod(shape[a] for a in dp)


def batch_sharding(mesh, tree: Tree) -> Tree:
    """Input batch: leading dim over the DP axes when divisible. Leaves
    are anything with a ``shape``."""
    dp, size = _dp(mesh)

    def one(x):
        shape = tuple(x.shape)
        if shape and size > 1 and shape[0] % size == 0:
            return Sharding(mesh, (dp if len(dp) > 1 else dp[0],))
        return Sharding(mesh, ())

    return tree_map(one, tree)


def cache_shardings(mesh, cache_tree: Tree) -> Tree:
    """KV caches / recurrent states: batch over DP when divisible; else
    the longest remaining dim over 'data' (long_500k: batch 1, shard the
    cache length instead). The model axis takes the kv-heads dim when it
    divides, else the sequence/length dim: a 110B decode_32k cache is
    687 GB and must shard over both axes. Leading 'layers' dims are never
    sharded."""
    shape = mesh_shape(mesh)
    dp, size = _dp(mesh)
    model = shape.get("model", 1)

    def one(x):
        # heuristic: dims are (layers?, batch, length/state..., heads, dh)
        xs = tuple(x.shape)
        parts: list = [None] * len(xs)
        # batch is dim 1 under a leading layers dim (ndim >= 3), else 0
        bdim = 1 if len(xs) >= 3 else 0
        if size > 1 and xs[bdim] % size == 0:
            parts[bdim] = dp if len(dp) > 1 else dp[0]
        elif "data" in shape and len(xs) > bdim + 1:
            # shard the longest non-batch dim over data
            rest = [(d, i) for i, d in enumerate(xs) if i > bdim]
            if rest:
                d, i = max(rest)
                if d % shape["data"] == 0:
                    parts[i] = "data"
        if model > 1:
            candidates = []
            if len(xs) >= 4:
                candidates.append(len(xs) - 2)   # kv-heads
            if len(xs) >= 3:
                candidates.append(bdim + 1)      # seq / length / heads
            for i in candidates:
                if parts[i] is None and xs[i] % model == 0:
                    parts[i] = "model"
                    break
        return Sharding(mesh, tuple(parts))

    return tree_map(one, cache_tree)
