"""AdamW with decoupled weight decay, global-norm clipping and a linear
warmup + cosine decay schedule, on nested-dict trees.

Counterpart of ``repro/optim/adamw.py``, step for step. Moments are f32
whatever the parameter dtype; the update is computed in f32 and cast
back. The schedule is computed in f32 arithmetic, as the reference's
jnp scalars are, so the learning rate is the reference's bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.common import tree_map, tree_paths

Tree = Any


class AdamState(NamedTuple):
    mu: Tree       # first moment (f32)
    nu: Tree       # second moment (f32)
    count: int     # updates applied so far


def init(params: Tree) -> AdamState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     count=0)


def schedule(cfg: RunConfig, step: int) -> float:
    """Learning rate after ``step`` updates, in f32 arithmetic."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    warm = torch.clamp(f32(step) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(f32(step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return float(cfg.lr * warm * (0.1 + 0.9 * cos))


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for _, x in tree_paths(tree)]
    return torch.stack(leaves).sum().sqrt()


def clip_by_global_norm(grads: Tree, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def update(grads: Tree, state: AdamState, params: Tree,
           cfg: RunConfig) -> tuple[Tree, AdamState, dict]:
    """Returns (new_params, new_state, metrics). ``grads`` may be any
    dtype; the math is f32. Weight decay is decoupled and skipped for
    1-D params (norm scales, biases), as in the reference."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.beta1, cfg.beta2
    # bias corrections as f32 values (exact as Python floats)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** float(count))
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** float(count))

    def upd(g, m, v, p):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        step = (m / c1) / ((v / c2).sqrt() + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:
            step = step + cfg.weight_decay * pf
        return (pf - lr * step).to(p.dtype), m, v

    out = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda k: tree_map(lambda t: t[k], out)
    return pick(0), AdamState(pick(1), pick(2), count), \
        {"grad_norm": gnorm, "lr": lr}
