"""Plain reference of the decoder configurations, in PyTorch.

A decoder-only transformer as the configuration files describe it:
token embedding; per layer a pre-norm (LayerNorm with a bias, or
RMSNorm), grouped-query attention with rotary positions (theta from the
file; the rotation pairs dim i with dim i + Dh/2), an optional bias on
q, k and v, a causal softmax over every earlier position (and a window
where the file states one), an output projection; then a pre-norm MLP:
tanh-approximated GELU with biases (``gelu_pytorch_tanh``), SwiGLU
(``silu``), or top-k experts of SwiGLU. A final norm and the head: its own matrix, or the token embedding's
transpose where the file ties them (``tie_word_embeddings``).

Experts: the router's softmax in f32, the k largest probabilities (the
lower expert first among equal ones), renormalised to sum to one. The
program's per-row capacity is part of the configuration as it is run
(``capacity_factor``, a departure from Mixtral's dropless routing that
the configuration file states): over a prompt of a row padded to
``padded_len`` tokens, each expert takes at most
``capacity(padded_len)`` entries, counted token by token and choice by
choice in order; an entry past it adds nothing and the token's other
choice keeps its weight. Tokens decoded after the prompt are never
dropped (a decode step's row holds one token).

It computes in float32 with TF32 off (``precision="f32"``), or, as the
lower-precision control, with both operands of every matrix product
rounded to float8 e4m3 with one scale per tensor (``"fp8"``). It imports
nothing of the program and no kernel: the weights are the benchmark's
(``portbench/weights.py``), read leaf by leaf as the tree lays them out,
and every function here takes the configuration file's dict.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_f32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Spec:
    """The sizes and kinds of a configuration file."""

    def __init__(self, cfg: dict):
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.d // self.h
        self.L = cfg["num_hidden_layers"]
        self.e = cfg.get("num_local_experts", 0)
        self.k = cfg.get("num_experts_per_tok", 0)
        self.cap_factor = cfg.get("capacity_factor", 0.0)
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg.get("norm_eps_as_run",
                                 cfg.get("norm_epsilon",
                                         cfg.get("rms_norm_eps", 1e-6))))
        self.layernorm = cfg.get("norm_type") == "layer_norm"
        self.act = cfg["hidden_act"]
        self.window = cfg.get("sliding_window") or 0

    def capacity(self, tokens: int) -> int:
        """Slots per expert per row for a row of ``tokens``: ``tokens *
        k / E * capacity_factor``, rounded up to a multiple of 16, at
        least 16."""
        c = int(tokens * self.k / self.e * self.cap_factor)
        return max(16, -(-c // 16) * 16)


def q8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 (e4m3, or e5m2 for gradients) with one
    scale for the tensor, back in float32."""
    s = x.abs().amax().clamp(min=1e-12) / FP8[fmt]
    return (x / s).to(fmt).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    """(..., k) @ (k, n) with the operands in e4m3 and, in the backward,
    the incoming gradient in e5m2: the usual float8 training recipe."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = q8(a), q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = q8(g, torch.float8_e5m2)
        ga = qg @ qb.T
        gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


def norm(x: torch.Tensor, scale, bias, sp: Spec) -> torch.Tensor:
    if sp.layernorm:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + sp.eps) * scale + bias
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + sp.eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, heads, Dh) rotated at positions ``pos`` (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, sp: Spec, chunk: int = 1024) -> torch.Tensor:
    """q (B, S, H, Dh), k/v (B, S, KV, Dh): causal softmax attention,
    query head i reading KV head i // (H / KV). Queries in chunks."""
    g = sp.h // sp.kv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = q.shape[1]
    scale = 1.0 / math.sqrt(sp.hd)
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi], k[:, :hi]) * scale
        keep = pos[None, :hi] <= pos[lo:hi, None]
        if sp.window:
            keep = keep & (pos[lo:hi, None] - pos[None, :hi] < sp.window)
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1),
                                 v[:, :hi]))
    return torch.cat(outs, dim=1)


def _w(W: dict, path: str, layer: Optional[int]) -> torch.Tensor:
    t = W[path] if layer is None else W[path][layer]
    return t.float()


def _head(W: dict) -> torch.Tensor:
    """(D, V): the head's matrix, or the tied embedding's transpose."""
    return _w(W, "embed.out", None) if "embed.out" in W \
        else _w(W, "embed.tok", None).T


def experts(h: torch.Tensor, W: dict, l: int, sp: Spec, prompt_len: int,
            padded_len: int, precision: str) -> torch.Tensor:
    """One row's expert layer: h (S, D) of which the first ``prompt_len``
    tokens were the prompt (padded to ``padded_len`` in its prefill)."""
    s = h.shape[0]
    probs = torch.softmax(mm(h, _w(W, "layers.moe.router", l), precision),
                          dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts = vals[:, :sp.k] / vals[:, :sp.k].sum(-1, keepdim=True)
    idx = idx[:, :sp.k]
    eids = idx.reshape(-1)                           # token-major entries
    tok = torch.arange(s, device=h.device).repeat_interleave(sp.k)
    onehot = F.one_hot(eids, sp.e) * (tok < prompt_len)[:, None]
    rank = (onehot.cumsum(0) - 1).gather(1, eids[:, None])[:, 0]
    kept = (tok >= prompt_len) | (rank < sp.capacity(padded_len))
    w = wts.reshape(-1) * kept
    out = torch.zeros_like(h)
    for j in range(sp.e):
        sel = (eids == j).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        x = h[tok[sel]]
        wi, wg, wo = (W[f"layers.moe.{n}"][l, j].float()
                      for n in ("wi", "wg", "wo"))
        y = mm(F.silu(mm(x, wg, precision)) * mm(x, wi, precision), wo,
               precision)
        out.index_add_(0, tok[sel], y * w[sel, None])
    return out


def mlp(h: torch.Tensor, W: dict, l: int, sp: Spec,
        precision: str) -> torch.Tensor:
    if sp.act == "silu":
        a = mm(h, _w(W, "layers.mlp.wi", l), precision)
        g = mm(h, _w(W, "layers.mlp.wg", l), precision)
        return mm(F.silu(g) * a, _w(W, "layers.mlp.wo", l), precision)
    a = mm(h, _w(W, "layers.mlp.wi", l), precision) + _w(W, "layers.mlp.bi",
                                                         l)
    return mm(F.gelu(a, approximate="tanh"), _w(W, "layers.mlp.wo", l),
              precision) + _w(W, "layers.mlp.bo", l)


def _norm_w(W: dict, name: str, l: Optional[int], sp: Spec):
    bias = _w(W, f"{name}.bias", l) if sp.layernorm else None
    return _w(W, f"{name}.scale", l), bias


def block(x: torch.Tensor, W: dict, l: int, sp: Spec, precision: str,
          rows: Sequence[tuple] = ()) -> torch.Tensor:
    """Layer ``l`` over x (B, S, D). ``rows`` gives each row's
    (prompt_len, padded_len) for the experts."""
    b, s, d = x.shape
    pos = torch.arange(s, device=x.device)
    h = norm(x, *_norm_w(W, "layers.ln1", l, sp), sp)
    proj = {}
    for name, heads in (("q", sp.h), ("k", sp.kv), ("v", sp.kv)):
        y = mm(h, _w(W, f"layers.attn.w{name}", l).reshape(d, heads * sp.hd),
               precision).reshape(b, s, heads, sp.hd)
        if f"layers.attn.b{name}" in W:
            y = y + _w(W, f"layers.attn.b{name}", l)
        proj[name] = y
    q = rope(proj["q"], pos, sp.theta)
    k = rope(proj["k"], pos, sp.theta)
    o = attention(q, k, proj["v"], sp).reshape(b, s, sp.h * sp.hd)
    x = x + mm(o, _w(W, "layers.attn.wo", l).reshape(sp.h * sp.hd, d),
               precision)
    h = norm(x, *_norm_w(W, "layers.ln2", l, sp), sp)
    if sp.e:
        y = torch.stack([experts(h[i], W, l, sp, *rows[i], precision)
                         for i in range(b)])
    else:
        y = mlp(h, W, l, sp, precision)
    return x + y


def served_logits(W: dict, cfg: dict, seqs: Sequence[dict],
                  precision: str = "f32") -> list:
    """Next-token logits (n, V) in f32 at each position a served token
    was chosen from. ``seqs``: dicts with ``prompt`` (ids), ``served``
    (the n tokens the program emitted) and ``padded_len`` (its prompt's
    length as prefilled). The layers run one after the other over every
    sequence, so each layer's weights are read once."""
    sp = Spec(cfg)
    dev = W["embed.tok"].device
    tok = W["embed.tok"]
    xs, plens = [], []
    for r in seqs:
        ids = list(r["prompt"]) + list(r["served"][:-1])
        xs.append(tok[torch.as_tensor(ids, device=dev)].float()[None])
        plens.append(len(r["prompt"]))
    with torch.no_grad():
        for l in range(sp.L):
            xs = [block(x, W, l, sp, precision,
                        rows=[(p, r["padded_len"])])
                  for x, p, r in zip(xs, plens, seqs)]
        out = []
        for x, p in zip(xs, plens):
            h = norm(x[0, p - 1:], *_norm_w(W, "ln_f", None, sp), sp)
            out.append(mm(h, _head(W), precision))
    return out


def loss(W: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict,
         precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross entropy over (B, S) tokens (dense
    configurations: no expert capacity in training here)."""
    sp = Spec(cfg)
    x = W["embed.tok"][tokens]
    for l in range(sp.L):
        x = block(x, W, l, sp, precision)
    x = norm(x, *_norm_w(W, "ln_f", None, sp), sp)
    logits = mm(x, _head(W), precision)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - gold).mean()


def lr_at(opt: dict, count: int) -> float:
    """Linear warm-up then cosine decay to a tenth, after ``count``
    updates."""
    warm = min(count / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((count - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(
        math.pi * prog)))


def train(W: dict, cfg: dict, batches: Sequence[dict], opt: dict,
          microbatches: int, precision: str = "f32",
          moments: Optional[dict] = None) -> dict:
    """AdamW steps from the f32 params ``W`` (modified in place), one per
    batch. ``moments`` (``m`` and ``v``, {path: f32 tensor}, modified in
    place, and ``count``, the updates made so far) continues an
    optimizer's state; without it the moments start at zero. Returns
    each step's loss, every leaf's clipped gradient norm at the first
    step (what the optimizer takes), and every leaf's norm of the change
    over all the steps."""
    p0 = {k: v.detach().clone() for k, v in W.items()}
    if moments is None:
        moments = {"m": {k: torch.zeros_like(v) for k, v in W.items()},
                   "v": {k: torch.zeros_like(v) for k, v in W.items()},
                   "count": 0}
    m, v2 = moments["m"], moments["v"]
    losses, first = [], None
    for step, batch in enumerate(batches, start=moments["count"] + 1):
        for t in W.values():
            t.requires_grad_(True)
            t.grad = None
        total = 0.0
        n = microbatches
        for tk, lb in zip(batch["tokens"].chunk(n), batch["labels"].chunk(n)):
            l = loss(W, tk, lb, cfg, precision) / n
            l.backward()
            total += float(l.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {k: t.grad for k, t in W.items()}
            gnorm = torch.sqrt(sum(g.double().square().sum()
                                   for g in grads.values()))
            scale = min(1.0, opt["grad_clip"] / max(float(gnorm), 1e-12))
            if first is None:
                first = {k: float(g.double().norm()) * scale
                         for k, g in grads.items()}
            lr = lr_at(opt, step)
            c1 = 1.0 - opt["beta1"] ** step
            c2 = 1.0 - opt["beta2"] ** step
            for k, t in W.items():
                g = grads[k] * scale
                m[k].mul_(opt["beta1"]).add_(g, alpha=1 - opt["beta1"])
                v2[k].mul_(opt["beta2"]).add_(g.square(),
                                              alpha=1 - opt["beta2"])
                upd = (m[k] / c1) / ((v2[k] / c2).sqrt() + opt["eps"])
                if t.dim() >= 2:      # stacked leaves: norms' scales too
                    upd = upd + opt["weight_decay"] * t
                t.sub_(lr * upd)
                t.grad = None
            del grads
    with torch.no_grad():
        change = {k: float((W[k] - p0[k]).double().norm()) for k in W}
    return {"losses": losses, "grad": first, "change": change}
