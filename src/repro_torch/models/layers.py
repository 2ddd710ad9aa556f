"""Shared layers: RMS norm and layer norm, RoPE, embeddings, LM head,
cross entropy, the SwiGLU and GELU MLPs.

Counterpart of ``repro/models/layers.py``. Functions
are pure and take their parameters as dict subtrees built from the
matching ``*_specs`` helpers. The reference's activation-sharding hook
(``shard_fn``) has no counterpart: a single card holds every tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def _check_kind(what: str, kind: str, kinds: tuple) -> None:
    if kind not in kinds:
        raise ValueError(f"unknown {what} kind {kind!r}: expected one of "
                         f"{kinds}")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


NORM_KINDS = ("rmsnorm", "layernorm")


def norm_specs(d: int, kind: str) -> dict:
    _check_kind("norm", kind, NORM_KINDS)
    out = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        out["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return out


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm, or layer norm with scale and bias (population variance,
    the reference's ``eps=1e-6`` default, not PyTorch's 1e-5), computed
    in f32 and returned in ``x``'s dtype."""
    _check_kind("norm", kind, NORM_KINDS)
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


MLP_KINDS = ("swiglu", "gelu")


def mlp_specs(d: int, f: int, kind: str, depth_scale: float) -> dict:
    """swiglu: ``wi, wg, wo``; gelu (starcoder2): ``wi, bi, wo, bo``."""
    _check_kind("mlp", kind, MLP_KINDS)
    if kind == "swiglu":
        return {
            "wi": ParamSpec((d, f), ("embed", "mlp")),
            "wg": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed"), scale=depth_scale),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "bi": ParamSpec((f,), ("mlp",), init="zeros"),
        "wo": ParamSpec((f, d), ("mlp", "embed"), scale=depth_scale),
        "bo": ParamSpec((d,), ("embed",), init="zeros"),
    }


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The gelu form is ``jax.nn.gelu``'s default, the tanh
    approximation (PyTorch's default is the erf form); ``bo`` is added
    after the down-projection."""
    _check_kind("mlp", kind, MLP_KINDS)
    h = torch.matmul(x, p["wi"].to(x.dtype))
    if kind == "swiglu":
        g = torch.matmul(x, p["wg"].to(x.dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h + p["bi"].to(x.dtype), approximate="tanh")
    out = torch.matmul(h, p["wo"].to(x.dtype))
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out
