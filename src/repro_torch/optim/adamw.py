"""AdamW with decoupled weight decay, global-norm clipping and a linear
warmup + cosine decay schedule, on nested-dict trees.

Counterpart of ``repro/optim/adamw.py``, step for step. Moments are f32
whatever the parameter dtype; the update is computed in f32 and cast
back. The schedule is computed in f32 arithmetic, as the reference's
jnp scalars are, so the learning rate is the reference's bit for bit.

Over a ``DeviceMesh`` (the gspmd step) params, gradients and moments are
DTensors at one placement per leaf: the global norm sums each leaf's
squares over the whole mesh, and the update, which is elementwise, runs
on each DTensor's local block.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import RunConfig
from repro_torch.models.common import tree_map, tree_paths

Tree = Any


class AdamState(NamedTuple):
    mu: Tree       # first moment (f32)
    nu: Tree       # second moment (f32)
    count: int     # updates applied so far


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros shaped and placed like ``p`` (a DTensor's at its
    placements)."""
    if isinstance(p, DTensor):
        local = p.to_local()
        return DTensor.from_local(
            torch.zeros(local.shape, dtype=torch.float32,
                        device=local.device), p.device_mesh, p.placements,
            run_check=False)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: Tree) -> AdamState:
    return AdamState(mu=tree_map(zeros_f32, params),
                     nu=tree_map(zeros_f32, params), count=0)


def schedule(cfg: RunConfig, step: int) -> float:
    """Learning rate after ``step`` updates, in f32 arithmetic."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    warm = torch.clamp(f32(step) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(f32(step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return float(cfg.lr * warm * (0.1 + 0.9 * cos))


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    s = x.float().square().sum()
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [_sq_sum(x) for _, x in tree_paths(tree)]
    return torch.stack(leaves).sum().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(every gradient in f32 scaled so the tree's global norm is at most
    ``max_norm``, the norm before clipping). ``update`` applies the same
    scale a chunk at a time instead of making the clipped tree."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _local(ts: tuple) -> tuple:
    """The local blocks of a leaf's gradient, moments and param: DTensors
    at one placement, or plain tensors."""
    if not any(isinstance(t, DTensor) for t in ts):
        return ts
    if not all(isinstance(t, DTensor) for t in ts) or len(
            {(t.device_mesh, t.placements) for t in ts}) != 1:
        raise ValueError(
            "the update needs the gradient, moments and param of a leaf as "
            "DTensors at one placement, got "
            + ", ".join(str(getattr(t, "placements", "plain")) for t in ts))
    return tuple(t.to_local() for t in ts)


# elements of a leaf that one pass of the update takes: its f32
# temporaries stay this small whatever the leaf (a 256k-row embedding is
# 1 B elements); every operation is elementwise, so the values do not
# depend on it
CHUNK = 1 << 24


def update(grads: Tree, state: AdamState, params: Tree,
           cfg: RunConfig, *, inplace: bool = False) -> tuple[Tree,
                                                              AdamState,
                                                              dict]:
    """Returns (new_params, new_state, metrics). ``grads`` may be any
    dtype; the math is f32. The gradients are clipped by their global
    norm; weight decay is decoupled and skipped for 1-D params (norm
    scales, biases), as in the reference. ``inplace`` writes the new
    params and moments into the tensors of ``params`` and ``state``
    (the caller gives them up, as the reference's jit donates its train
    state), so no second copy of them lives; the values are the same bit
    for bit. Either way each leaf is updated ``CHUNK`` elements at a
    time, its clipped f32 gradient included."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    count = state.count + 1
    lr = schedule(cfg, count)
    # bias corrections as f32 values (exact as Python floats)
    c1 = float(1.0 - torch.tensor(cfg.beta1, dtype=torch.float32)
               ** float(count))
    c2 = float(1.0 - torch.tensor(cfg.beta2, dtype=torch.float32)
               ** float(count))
    mu, nu = state.mu, state.nu
    if not inplace:
        params, mu, nu = (tree_map(torch.clone, t) for t in (params, mu, nu))
    for (_, g), (_, m), (_, v), (_, p) in zip(
            tree_paths(grads), tree_paths(mu), tree_paths(nu),
            tree_paths(params)):
        decay = p.dim() >= 2
        g, m, v, p = _local((g, m, v, p))
        g = g.reshape(-1)
        m, v, p = (t.view(-1) for t in (m, v, p))
        for i in range(0, p.numel(), CHUNK):
            s = slice(i, i + CHUNK)
            _adam_(g[s], m[s], v[s], p[s], scale, lr, c1, c2, cfg, decay)
    return params, AdamState(mu, nu, count), \
        {"grad_norm": gnorm, "lr": lr}


def _adam_(g, m, v, p, scale, lr: float, c1: float, c2: float,
           cfg: RunConfig, decay: bool) -> None:
    """One chunk's update, written into ``m``, ``v`` and ``p``: the
    reference's f32 operations in its order, each rounded as there."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale                     # the clipped gradient
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.square().mul_(1 - b2))
    del g
    step = m.div(c1).div_(v.div(c2).sqrt_().add_(cfg.eps))
    pf = p.float()                            # p itself when p is f32
    if decay:
        step.add_(pf * cfg.weight_decay)
    p.copy_(pf.sub_(step.mul_(lr)))
