"""Shared layers: RMS norm and layer norm, RoPE, embeddings, LM head,
cross entropy, SwiGLU MLP.

Counterpart of ``repro/models/layers.py``. Functions
are pure and take their parameters as dict subtrees built from the
matching ``*_specs`` helpers. The reference's activation-sharding hook
(``shard_fn``) has no counterpart: a single card holds every tensor.
Other norm and MLP kinds raise ``NotImplementedError`` until the
families that use them are ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Queue 1: "
        "'The other model families')")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


NORM_KINDS = ("rmsnorm", "layernorm")


def norm_specs(d: int, kind: str) -> dict:
    if kind not in NORM_KINDS:
        raise _unported(f"norm kind {kind!r}")
    out = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        out["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return out


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm, or layer norm with scale and bias (population variance,
    the reference's ``eps=1e-6`` default, not PyTorch's 1e-5), computed
    in f32 and returned in ``x``'s dtype."""
    if kind not in NORM_KINDS:
        raise _unported(f"norm kind {kind!r}")
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq            # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


def embedding_specs(vocab: int, d: int, tie: bool) -> dict:
    out = {"tok": ParamSpec((vocab, d), ("vocab", "embed"))}
    if not tie:
        out["out"] = ParamSpec((d, vocab), ("embed", "vocab"))
    return out


def embed_tokens(p: dict, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return p["tok"][tokens].to(dtype)


def lm_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B,S,D) -> (B,S,V); tied embeddings use ``tok.T``."""
    w = p.get("out")
    if w is None:
        w = p["tok"].T
    return torch.matmul(x, w.to(x.dtype))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy with f32 reductions (the reference's
    formulation: logsumexp minus the gold logit)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_specs(d: int, f: int, kind: str, depth_scale: float) -> dict:
    if kind != "swiglu":
        raise _unported(f"mlp kind {kind!r}")
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "wg": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed"), scale=depth_scale),
    }


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise _unported(f"mlp kind {kind!r}")
    h = torch.matmul(x, p["wi"].to(x.dtype))
    g = torch.matmul(x, p["wg"].to(x.dtype))
    return torch.matmul(F.silu(g) * h, p["wo"].to(x.dtype))
