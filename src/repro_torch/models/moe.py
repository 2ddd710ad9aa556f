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

``shard_fn`` (``layers.ShardFn``) pins the reference's four sites: the
dispatched buffer and the expert stage's output at ``("batch",
"experts", None, None)``, its hidden activation at ``("batch",
"experts", None, "mlp")`` and the combined output at ``("batch", "seq",
None)``. Over a ``DeviceMesh`` (DTensor activations) routing, the
capacity scatter and the combine run on each peer's own rows through
explicit ``local_map``s (:func:`_route`, :func:`_combine`): DTensor has
no sharding strategy for the stable sort, the rank scatter, ``cummax``
or the three-tensor index, and they are per row, as the reference's
docstring says, so no token crosses a peer there. Each peer takes its
rows' whole sequence (``capacity`` counts it; SP splits it over
``model``), the router whole. The dispatched buffer then splits its
experts over ``model`` (a local slice), the expert GEMMs run on
DTensors against the expert weights at ``param_shardings``, and the
combine gathers the experts back. The balance loss is a mean over the
global batch: each peer returns its rows' sums, which DTensor reduces
over the batch's mesh dims.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import (ShardFn, even_reshape, kept_shards,
                                       no_shard)


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


def apply_experts(p: dict, buf: torch.Tensor, cfg: ModelConfig,
                  shard_fn: ShardFn = no_shard) -> torch.Tensor:
    """The expert stage alone: grouped swiglu over a dispatched
    ``(B, E', C, D)`` buffer, one GEMM per expert over all its rows'
    slots. ``E'`` may be a slice of the expert axis (the serving
    expert-parallel path runs its peer's slice); ``p["wi"]``, ``["wg"]``
    and ``["wo"]`` are then the matching ``(E', ...)`` slices. The
    merge of the batch and the slots goes through
    ``layers.even_reshape`` (over a mesh the batch is split)."""
    dt = buf.dtype
    b, e, c, d = buf.shape
    x = even_reshape(buf.transpose(0, 1), (e, b * c, d))
    h = torch.bmm(x, p["wi"].to(dt))
    g = torch.bmm(x, p["wg"].to(dt))
    f = h.shape[-1]
    h = even_reshape(F.silu(g) * h, (e, b, c, f)).transpose(0, 1)
    h = shard_fn(h, ("batch", "experts", None, "mlp"))
    out = torch.bmm(even_reshape(h.transpose(0, 1), (e, b * c, f)),
                    p["wo"].to(dt))
    out = even_reshape(out, (e, b, c, d)).transpose(0, 1)
    return shard_fn(out, ("batch", "experts", None, None))


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           c: int):
    """Routing and dispatch of whole rows: x (B, S, D) -> (buf (B, E, C,
    D), eids and ranks (B, S*k), weights (B, S, k), and the rows' sums
    for the aux losses: router probabilities (B, E), entries per expert
    (B, E), squared router logsumexp (B,))."""
    m = cfg.moe
    b, s, d = x.shape
    k, e = m.top_k, m.num_experts
    dt = x.dtype
    # route (per token): the router product in the compute dtype, the
    # softmax in f32
    logits = torch.matmul(x, router.to(dt)).float()
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
    counts = torch.zeros(b, e, dtype=eids.dtype, device=eids.device
                         ).scatter_add_(1, eids, torch.ones_like(eids))
    z = torch.logsumexp(logits, dim=-1).square().sum(dim=1)
    return buf, eids, ranks, weights, probs.sum(dim=1), counts.float(), z


def _combine(out_buf: torch.Tensor, eids: torch.Tensor, ranks: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Each (token, choice) reads its slot, a dropped one slot c - 1 at
    weight 0; the weighted sum over the k choices: (B, S, D)."""
    b, _, c, d = out_buf.shape
    s, k = weights.shape[1:]
    rows = torch.arange(b, device=out_buf.device)[:, None]
    gathered = out_buf[rows, eids, ranks.clamp(max=c - 1)]
    gathered = gathered.view(b, s, k, d)
    kept = weights * (ranks < c).view(b, s, k)
    return torch.matmul(kept.to(out_buf.dtype)[:, :, None, :],
                        gathered)[:, :, 0]


def _rowwise(fn, n_out: int, x: DTensor, *rest, grads: tuple = ()):
    """``fn`` on each peer's rows through an explicit ``local_map``: the
    batch split of ``x`` kept, every other dim whole, ``rest`` at the
    same placements; ``n_out`` outputs at them too. ``grads`` (the
    indices of replicated inputs) take ``Partial`` gradients over the
    batch's mesh dims: each peer's rows give part of the sum."""
    mesh = x.device_mesh
    pl = kept_shards(x, (0,))
    ins = [pl] * (1 + len(rest))
    g = list(ins)
    for i in grads:
        ins[i] = [Replicate()] * mesh.ndim
        g[i] = [Partial() if isinstance(q, Shard) else Replicate()
                for q in pl]
    out = pl if n_out == 1 else (pl,) * n_out
    return local_map(fn, out_placements=out, in_placements=tuple(ins),
                     in_grad_placements=tuple(g), device_mesh=mesh,
                     redistribute_inputs=True)(x, *rest)


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              shard_fn: ShardFn = no_shard,
              expert_fn: Optional[Callable] = None):
    """x: (B, S, D) -> (out, aux). ``expert_fn(p, buf, cfg, shard_fn) ->
    out_buf`` replaces the expert stage alone (default
    :func:`apply_experts`): the seam the serving dispatch uses for its
    expert-parallel exchange. Routing, the capacity scatter and the
    combine are per row and the same either way. ``aux`` is the Switch
    balance loss (weight 0.01) plus the router z-loss (weight 1e-3),
    f32, over the global batch."""
    m = cfg.moe
    b, s, _ = x.shape
    k, e = m.top_k, m.num_experts
    c = capacity(s, cfg)
    route = lambda xl, rl: _route(xl, rl, cfg, c)
    if isinstance(x, DTensor):
        routed = _rowwise(route, 7, x, p["router"], grads=(1,))
    else:
        routed = route(x, p["router"])
    buf, eids, ranks, weights, prob_sums, counts, z_sums = routed
    buf = shard_fn(buf, ("batch", "experts", None, None))
    out_buf = (expert_fn or apply_experts)(p, buf, cfg, shard_fn)
    if isinstance(out_buf, DTensor):
        out = _rowwise(_combine, 1, out_buf, eids, ranks, weights)
    else:
        out = _combine(out_buf, eids, ranks, weights)
    out = shard_fn(out, ("batch", "seq", None))

    # aux losses: load balance (Switch) + router z-loss, means over the
    # global batch from the rows' sums
    me = prob_sums.sum(dim=0) / (b * s)
    frac = counts.sum(dim=0) / (b * s * k)
    lb = e * (me * frac).sum()
    z = z_sums.sum() / (b * s)
    return out, 0.01 * lb + 1e-3 * z
