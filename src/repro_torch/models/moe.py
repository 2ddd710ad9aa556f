"""Token-choice top-k mixture of experts with per-row (grouped) sort
dispatch.

Counterpart of ``repro/models/moe.py``, term for term. Dispatch is
computed per batch row (the GShard "group" trick, G = batch): every
(token, choice) gets its rank among the row's entries for the same
expert by a stable sort and a change-point cummax; ranks at or past the
row's capacity drop. The expert stage runs on a ``(B, E, C, D)``
dispatch buffer, so its FLOPs are the capacity's, not the dense
``E x S`` product.

Branch-free on the card: the reference's scatter ``mode="drop"`` and
gather ``mode="fill"`` have no PyTorch counterpart, and a boolean mask
would make shapes data-dependent (a device-to-host sync). Instead the
buffer carries one spare slot per expert: a dropped entry is written to
slot ``C`` (its rank clamped there), which is sliced off before the
expert stage. The combine reads a dropped entry from slot ``C - 1``
and weighs it by zero, the same sum as the reference's zero fill.

Top-k follows ``jax.lax.top_k``'s order: larger first, and the lower
expert index first among equal probabilities (``torch.topk`` promises
no order on ties, and bf16 router logits do tie), by a stable
descending sort.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert per row: ``S * k / E * capacity_factor``, rounded
    up to a multiple of 16, at least 16."""
    m = cfg.moe
    c = int(tokens_per_group * m.top_k / m.num_experts * m.capacity_factor)
    return max(16, -(-c // 16) * 16)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: (values, indices), larger
    first, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ranks_within_expert(eids: torch.Tensor) -> torch.Tensor:
    """eids: (B, N) expert ids. Returns (B, N): each entry's rank among
    the same-expert entries of its row, in entry order."""
    b, n = eids.shape
    order = torch.argsort(eids, dim=-1, stable=True)
    sorted_e = torch.gather(eids, -1, order)
    idx = torch.arange(n, device=eids.device).expand(b, n)
    change = torch.ones_like(sorted_e, dtype=torch.bool)
    change[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    running_start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    return torch.zeros_like(eids).scatter_(1, order, idx - running_start)


def apply_experts(p: dict, buf: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The expert stage alone: grouped swiglu over a dispatched
    ``(B, E', C, D)`` buffer, one GEMM per expert over all its rows'
    slots. ``E'`` may be a slice of the expert axis (the serving
    expert-parallel path runs its peer's slice); ``p["wi"]``, ``["wg"]``
    and ``["wo"]`` are then the matching ``(E', ...)`` slices."""
    dt = buf.dtype
    b, e, c, d = buf.shape
    x = buf.transpose(0, 1).reshape(e, b * c, d)
    h = torch.bmm(x, p["wi"].to(dt))
    g = torch.bmm(x, p["wg"].to(dt))
    out = torch.bmm(F.silu(g) * h, p["wo"].to(dt))
    return out.view(e, b, c, d).transpose(0, 1)


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              expert_fn: Optional[Callable] = None):
    """x: (B, S, D) -> (out, aux). ``expert_fn(p, buf, cfg) -> out_buf``
    replaces the expert stage alone (default :func:`apply_experts`): the
    seam the serving dispatch uses for its expert-parallel exchange.
    Routing, the capacity scatter and the combine are per row and the
    same either way. ``aux`` is the Switch balance loss (weight 0.01)
    plus the router z-loss (weight 1e-3), f32."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.top_k, m.num_experts
    c = capacity(s, cfg)
    dt = x.dtype

    # route (per token): the router product in the compute dtype, the
    # softmax in f32
    logits = torch.matmul(x, p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, k)                       # (B, S, k)
    weights = weights / weights.sum(dim=-1, keepdim=True)

    # per-row rank within expert; over capacity -> the spare slot c
    eids = idx.reshape(b, s * k)
    ranks = _ranks_within_expert(eids)
    slot = eids * (c + 1) + ranks.clamp(max=c)
    slot = slot[..., None].expand(b, s * k, d)

    # dispatch: token t's k copies into their (expert, rank) slots
    buf = x.new_zeros(b, e * (c + 1), d)
    buf.scatter_(1, slot, x[:, :, None].expand(b, s, k, d).reshape(
        b, s * k, d))
    buf = buf.view(b, e, c + 1, d)[:, :, :c]

    out_buf = (expert_fn or apply_experts)(p, buf, cfg)

    # combine: each (token, choice) reads its slot, a dropped one slot
    # c - 1 at weight 0; weighted sum over the k choices
    rows = torch.arange(b, device=x.device)[:, None]
    gathered = out_buf[rows, eids, ranks.clamp(max=c - 1)]
    gathered = gathered.view(b, s, k, d)
    kept = weights * (ranks < c).view(b, s, k)
    out = torch.matmul(kept.to(dt)[:, :, None, :], gathered)[:, :, 0]

    # aux losses: load balance (Switch) + router z-loss
    me = probs.mean(dim=(0, 1))
    flat = eids.reshape(-1)             # counts with no host sync
    frac = torch.zeros(e, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float() / flat.numel()
    lb = e * (me * frac).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return out, 0.01 * lb + 1e-3 * z
