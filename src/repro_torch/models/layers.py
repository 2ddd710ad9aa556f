"""Shared layers: RMS norm and layer norm, RoPE, embeddings, LM head,
cross entropy, the SwiGLU and GELU MLPs.

Counterpart of ``repro/models/layers.py``. Functions
are pure and take their parameters as dict subtrees built from the
matching ``*_specs`` helpers. Activation sharding constraints are
injected through the ``shard_fn`` threaded through model code: the
identity (:func:`no_shard`) on one peer, ``launch/sharding.make_shard_fn``
over a ``DeviceMesh``, where parameters and activations are DTensors.

Two ops have no DTensor sharding strategy at the rules' placements, and
each takes an explicit ``torch.distributed.tensor.experimental.local_map``
here (the values are those of the plain path):

* :func:`embed_tokens` on a table whose vocab dim is sharded (the
  ``vocab -> model`` rule): DTensor's masked-embedding buffer breaks when
  the ids are sharded over another mesh dim. The table is redistributed
  with its ``embed`` dim gathered (its vocab sharding kept), each peer
  looks its vocab rows up with the others masked to zero, and the
  result is ``Partial`` (a sum) over the vocab's mesh dims: Megatron's
  vocab-parallel embedding.
* :func:`cross_entropy` over vocab-sharded logits (the ``("batch", None,
  "vocab")`` constraint): ``gather`` over a sharded dim. The logits are
  redistributed with the vocab dim whole (the batch sharding kept), and
  each peer computes its own rows' token losses.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import ParamSpec

ShardFn = Callable[[torch.Tensor, tuple], torch.Tensor]


def no_shard(x: torch.Tensor, logical_axes: tuple) -> torch.Tensor:
    return x


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
    if isinstance(p["tok"], DTensor):
        return _embed_vocab_parallel(p["tok"], tokens, dtype)
    return p["tok"][tokens].to(dtype)


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """A plain tensor (the same on every peer) as a replicated DTensor."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def kept_shards(t: DTensor, dims: tuple) -> list:
    """``t``'s placements with its split of each dim in ``dims`` kept and
    every other placement (a split of another dim, a pending sum) made
    ``Replicate``: the blocks of a local computation that needs the
    other dims whole on each peer."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in t.placements]


def whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with ``dim`` whole on every peer: a DTensor split along it
    is gathered there (its other placements kept), anything else comes
    back as it is. For ops DTensor runs on an unsplit dim only
    (``unbind``), where its propagation may have split a short dim
    unevenly (rwkv6's five token-shift branches over ``model``)."""
    if not isinstance(t, DTensor) or Shard(dim) not in t.placements:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p == Shard(dim) else p for p in t.placements])


def mesh_block(mesh, dims: list) -> tuple:
    """(this peer's block index, the number of blocks) of a tensor dim
    split over the mesh dims ``dims``: they nest in mesh order, as
    DTensor lays a dim out over several mesh dims."""
    coord = mesh.get_coordinate()
    block, n = 0, 1
    for i in dims:
        block = block * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return block, n


def _embed_vocab_parallel(tok: DTensor, tokens: torch.Tensor,
                          dtype: torch.dtype) -> DTensor:
    """The lookup of ``tokens`` in a DTensor table: ``embed`` gathered,
    vocab rows looked up where they live (module docstring)."""
    mesh = tok.device_mesh
    ids = as_dtensor(tokens, mesh)
    vocab = [i for i, pl in enumerate(tok.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    t_pl = [Shard(0) if i in vocab else Replicate()
            for i in range(mesh.ndim)]
    i_pl = [Replicate() if i in vocab else pl
            for i, pl in enumerate(ids.placements)]
    out_pl = [Partial() if i in vocab else pl for i, pl in enumerate(i_pl)]
    # the table's gradient: each peer's rows over the ids' sharded mesh
    # dims add up (a sum), its vocab block stays its own
    g_pl = [Shard(0) if i in vocab else
            Partial() if isinstance(pl, Shard) else Replicate()
            for i, pl in enumerate(i_pl)]
    # this peer's first vocab row: its block index times the block's rows
    block, n_blocks = mesh_block(mesh, vocab)
    rows = tok.shape[0] // n_blocks

    def lookup(table, ids):
        if not vocab:
            return table[ids].to(dtype)
        local = ids - block * rows
        inside = (local >= 0) & (local < rows)
        got = table[torch.where(inside, local, 0)].to(dtype)
        return torch.where(inside[..., None], got, 0)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(t_pl, i_pl),
                     in_grad_placements=(g_pl, i_pl), device_mesh=mesh,
                     redistribute_inputs=True)(tok, ids)


def _even_placements(t: DTensor, shape: tuple) -> list:
    """``t``'s placements with every mesh dim that shards a dim the
    reshape to ``shape`` splits unevenly (its first factor not a multiple
    of the mesh dim's size) made ``Replicate``."""
    src, mesh = tuple(t.shape), t.device_mesh
    out = list(t.placements)
    for i, p in enumerate(out):
        d = getattr(p, "dim", None)
        if d is None:
            continue
        before, acc, j = math.prod(src[:d]), 1, 0
        while j < len(shape) and acc < before:
            acc *= shape[j]
            j += 1
        if acc == before and j < len(shape) and shape[j] != src[d] \
                and shape[j] % mesh.size(i):
            out[i] = Replicate()
    return out


def _even_view(t: DTensor, shape: tuple) -> DTensor:
    pl = _even_placements(t, shape)
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t.reshape(shape)


class _EvenView(torch.autograd.Function):
    """A DTensor reshape whose forward gathers first the mesh dims of a
    dim it would split unevenly, and whose backward first gathers every
    dim the gradient shards where the forward's output did not: the
    reverse of a valid reshape is then valid (the gradient may arrive
    split along a dim the reshape merges, e.g. the sequence under SP,
    which torch 2.11's DTensor cannot flatten)."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.src = tuple(t.shape)
        out = _even_view(t, shape)
        ctx.out_pl = tuple(out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        pl = [Replicate() if getattr(p, "dim", None) is not None
              and p != q else p for p, q in zip(g.placements, ctx.out_pl)]
        if pl != list(g.placements):
            g = g.redistribute(g.device_mesh, pl)
        return _even_view(g, ctx.src), None


def even_reshape(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``t.reshape(shape)``. DTensor's reshape has no strategy for a
    split whose first factor the sharding mesh dim does not divide (it
    raises), and its propagation picks such layouts (a decode step's few
    rows shard a projection's flat ``H*Dh`` columns; a backward shards
    the flat gradient): over a mesh that dim is gathered first, forward
    and backward (e.g. 14 heads on a 16-way ``model`` axis)."""
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    return _EvenView.apply(t, tuple(shape))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``, the leading dims of ``x`` folded into
    the rows of one ``mm``: ``torch.matmul``'s own fold on plain tensors
    (the same ops, the same bits). On a DTensor ``torch.matmul`` does not
    fold (a (B, 1, D) decode activation runs a batched product whose
    sums round otherwise); folding here keeps a one-peer mesh bitwise
    one peer. A (B, S, D) DTensor split along S (the sequence under SP)
    is not folded: torch 2.11's DTensor cannot flatten a sharded inner
    dim (its ``torch.matmul`` folds and raises), so it runs one batched
    product against ``w`` broadcast over the batch, which keeps the dims
    apart."""
    lead = tuple(x.shape[:-1])
    if isinstance(x, DTensor) and x.ndim == 3 and any(
            getattr(p, "dim", 0) == 1 for p in x.placements):
        return torch.bmm(x, w.expand(x.shape[0], *w.shape))
    y = torch.mm(even_reshape(x, (math.prod(lead), x.shape[-1])), w)
    return even_reshape(y, (*lead, w.shape[-1]))


def lm_logits(p: dict, x: torch.Tensor,
              shard_fn: ShardFn = no_shard) -> torch.Tensor:
    """(B,S,D) -> (B,S,V); tied embeddings use ``tok.T``."""
    w = p.get("out")
    if w is None:
        w = p["tok"].T
    return shard_fn(matmul(x, w.to(x.dtype)), ("batch", None, "vocab"))


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - gold


def _token_nll_sharded(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """Per-token losses of DTensor logits: the vocab dim whole on each
    peer, the leading dims as the logits have them (module docstring)."""
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = [Replicate() if isinstance(p, Partial)
          or (isinstance(p, Shard) and p.dim == last) else p
          for p in logits.placements]
    return local_map(_token_nll, out_placements=pl, in_placements=(pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, as_dtensor(labels, mesh))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy with f32 reductions (the reference's
    formulation: logsumexp minus the gold logit)."""
    nll = (_token_nll_sharded if isinstance(logits, DTensor)
           else _token_nll)(logits, labels)
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


def apply_mlp(p: dict, x: torch.Tensor, kind: str,
              shard_fn: ShardFn = no_shard) -> torch.Tensor:
    """The gelu form is ``jax.nn.gelu``'s default, the tanh
    approximation (PyTorch's default is the erf form); ``bo`` is added
    after the down-projection."""
    _check_kind("mlp", kind, MLP_KINDS)
    h = matmul(x, p["wi"].to(x.dtype))
    if kind == "swiglu":
        g = matmul(x, p["wg"].to(x.dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h + p["bi"].to(x.dtype), approximate="tanh")
    h = shard_fn(h, ("batch", None, "mlp"))
    out = matmul(h, p["wo"].to(x.dtype))
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out
