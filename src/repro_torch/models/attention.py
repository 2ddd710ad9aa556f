"""Attention: GQA projections, plain attention, decode against a cache.

Counterpart of ``repro/models/attention.py``. Regimes:

* prefill attention runs the hand-written CUDA kernel through
  ``kernels/ops.flash_attention`` (the call is in ``transformer.py``),
  which reads K/V at their KV heads in place;
  ``attend_chunked`` here is its plain chunked online-softmax version,
  which train mode runs (autograd differentiates it), and
  ``attend_direct`` the one-block version both rest on.
* ``decode_attend`` — one new token against the KV cache, plain PyTorch
  (the reference's decode is jnp too, not a Pallas kernel). It groups
  the query heads over their KV head instead of expanding the cache,
  which computes the same dot products without copying the cache.

KV caches: full-attention caches are (B, S_max, KV, Dh) written at
``pos``; windowed caches are rolling (slot = pos % window). Decode
writes the new token's K/V into the cache IN PLACE (the reference
returns a new array), which saves a cache-sized copy per layer and step.
``kv_cache_specs`` is the cache's layout as ``meta`` tensors.

``shard_fn`` (``layers.ShardFn``) pins the reference's activation
constraints at its 11 sites: q, k and v after the projections, the
output projection, and decode's flash-decoding layout (q replicated, the
cache's length over ``model``, the scores length-sharded, the output
back at its heads).
"""
from __future__ import annotations

import math

import torch

from repro_torch.compat import torch_dtype
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import ShardFn, no_shard, rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def attention_specs(d: int, num_heads: int, num_kv: int, head_dim: int,
                    bias: bool, depth_scale: float) -> dict:
    s: dict = {
        "wq": ParamSpec((d, num_heads, head_dim), ("embed", "heads", None)),
        "wk": ParamSpec((d, num_kv, head_dim), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, num_kv, head_dim), ("embed", "kv_heads", None)),
        "wo": ParamSpec((num_heads, head_dim, d), ("heads", None, "embed"),
                        scale=depth_scale),
    }
    if bias:
        s["bq"] = ParamSpec((num_heads, head_dim), ("heads", None), init="zeros")
        s["bk"] = ParamSpec((num_kv, head_dim), ("kv_heads", None), init="zeros")
        s["bv"] = ParamSpec((num_kv, head_dim), ("kv_heads", None), init="zeros")
    return s


def project_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor,
                q_positions: torch.Tensor, kv_positions: torch.Tensor,
                rope_theta: float, shard_fn: ShardFn = no_shard):
    """Returns q (B,Sq,H,Dh), k/v (B,Skv,KV,Dh); RoPE applied to q and k."""
    dt = xq.dtype
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = rope(q, q_positions, rope_theta)
    k = rope(k, kv_positions, rope_theta)
    q = shard_fn(q, ("batch", None, "heads", None))
    k = shard_fn(k, ("batch", None, "kv_heads", None))
    v = shard_fn(v, ("batch", None, "kv_heads", None))
    return q, k, v


def out_project(p: dict, attn: torch.Tensor,
                shard_fn: ShardFn = no_shard) -> torch.Tensor:
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(attn.dtype))
    return shard_fn(out, ("batch", None, "embed"))


def expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B,S,KV,Dh) -> contiguous (B,S,H,Dh): query head h reads KV head
    h // (H // KV), as in the reference. The plain versions use it; the
    kernel reads the KV heads in place."""
    b, s, kv, dh = k.shape
    g = num_heads // kv
    if g == 1:
        return k.contiguous()
    # with one KV head (MQA) the reshape of the expanded view is itself a
    # view with stride 0 over the heads; the kernel needs dense rows
    return k[:, :, :, None, :].expand(b, s, kv, g, dh).reshape(
        b, s, num_heads, dh).contiguous()


# ---------------------------------------------------------------------------
# Plain attention (the kernel's reference versions)
# ---------------------------------------------------------------------------


def _scores_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                 window: int, valid_len=None) -> torch.Tensor:
    """(Sq, Skv) boolean validity from absolute positions."""
    m = kpos[None, :] >= 0
    if valid_len is not None:
        m = m & (kpos[None, :] < valid_len)
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        m = m & ((qpos[:, None] - kpos[None, :]) < window)
    return m


def attend_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, *,
                  causal: bool, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,Dh); k/v: (B,Skv,H,Dh) (already expanded). Scores and
    the PV sum in f32; the probabilities are cast to v's dtype first."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _scores_mask(qpos, kpos, causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _online_block(state, q, kc, vc, qpos, kpos, causal, window, valid_len):
    """One KV chunk of online softmax. q: (B,Sq,H,Dh); kc/vc: (B,Kc,H,Dh);
    state = (m, l, acc) with m/l (B,H,Sq), acc (B,H,Sq,Dh), all f32."""
    m, l, acc = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) * scale
    mask = _scores_mask(qpos, kpos, causal, window, valid_len)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
    return m_new, l_new, acc * corr[..., None] + pv


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Flash-style chunked attention, the reference's ``attend_chunked``
    step for step: q: (B,S,H,Dh), k/v: (B,S,KV,Dh) with H % KV == 0,
    positions 0..S-1. Given fewer heads than q, k/v are expanded here
    first (``expand_kv``), so it computes what it computes on expanded
    k/v. Query chunk i reads only the KV prefix (causal) or band
    (windowed) it can see."""
    b, s_valid, h, dh = q.shape
    if k.shape != v.shape or k.shape[2] < 1 or h % k.shape[2] \
            or (k.shape[0], k.shape[1], k.shape[3]) != (b, s_valid, dh):
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)}")
    if k.shape[2] != h:
        k, v = expand_kv(k, h), expand_kv(v, h)
    dev = q.device
    if s_valid <= q_chunk:
        pos = torch.arange(s_valid, device=dev)
        return attend_direct(q, k, v, pos, pos, causal=causal, window=window)
    # pad to a q_chunk multiple; padded keys are masked via valid_len,
    # padded queries are sliced off
    s = -(-s_valid // q_chunk) * q_chunk
    if s != s_valid:
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, s - s_valid))
        q, k, v = pad(q), pad(k), pad(v)

    outs = []
    for i in range(s // q_chunk):
        q_i = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpos = i * q_chunk + torch.arange(q_chunk, device=dev)
        if causal and window <= 0:
            kv_start, kv_end = 0, (i + 1) * q_chunk
        elif window > 0:
            lo = i * q_chunk - (-(-window // kv_chunk)) * kv_chunk
            kv_start, kv_end = max(0, lo), (i + 1) * q_chunk
        else:
            kv_start, kv_end = 0, s
        k_i, v_i = k[:, kv_start:kv_end], v[:, kv_start:kv_end]
        span = kv_end - kv_start
        state = (torch.full((b, h, q_chunk), NEG_INF, device=dev),
                 torch.zeros((b, h, q_chunk), device=dev),
                 torch.zeros((b, h, q_chunk, dh), device=dev))
        if span <= kv_chunk:
            kpos = kv_start + torch.arange(span, device=dev)
            state = _online_block(state, q_i, k_i, v_i, qpos, kpos, causal,
                                  window, s_valid)
        else:
            nk = -(-span // kv_chunk)
            lpad = nk * kv_chunk - span  # left-pad; padded kpos < 0 masked
            if lpad:
                padl = lambda x: torch.nn.functional.pad(
                    x, (0, 0, 0, 0, lpad, 0))
                k_i, v_i = padl(k_i), padl(v_i)
            base = kv_start - lpad
            for j in range(nk):
                kpos = base + j * kv_chunk + torch.arange(kv_chunk, device=dev)
                sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
                state = _online_block(state, q_i, k_i[:, sl], v_i[:, sl],
                                      qpos, kpos, causal, window, s_valid)
        _, l, acc = state
        out_i = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out_i.transpose(1, 2).to(q.dtype))   # (B,qc,H,Dh)
    return torch.cat(outs, dim=1)[:, :s_valid]


# ---------------------------------------------------------------------------
# Decode-step attention against a cache
# ---------------------------------------------------------------------------


def to_rolling(k: torch.Tensor, window: int) -> torch.Tensor:
    """Chronological prefill cache (B,S,KV,Dh) -> the rolling layout
    windowed decode expects: length ``window``, position p at slot
    p % window. Pads when S < window."""
    s = k.shape[1]
    if s >= window:
        return torch.roll(k[:, s - window:s], s % window, dims=1)
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, window - s))


def init_kv_cache(num_layers: int, batch: int, max_len: int, num_kv: int,
                  head_dim: int, dtype: torch.dtype,
                  device: torch.device) -> dict:
    sh = (num_layers, batch, max_len, num_kv, head_dim)
    return {"k": torch.zeros(sh, dtype=dtype, device=device),
            "v": torch.zeros(sh, dtype=dtype, device=device)}


def kv_cache_specs(num_layers: int, batch: int, max_len: int, num_kv: int,
                   head_dim: int, dtype: str) -> dict:
    """The layout of :func:`init_kv_cache` as ``meta`` tensors
    (``dtype``: a config dtype name)."""
    dt = torch_dtype(dtype)
    sh = (num_layers, batch, max_len, num_kv, head_dim)
    return {"k": torch.empty(sh, dtype=dt, device="meta"),
            "v": torch.empty(sh, dtype=dt, device="meta")}


def decode_attend(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, new_k: torch.Tensor,
                  new_v: torch.Tensor, pos: torch.Tensor, *,
                  num_heads: int, window: int = 0,
                  shard_fn: ShardFn = no_shard):
    """Single-token decode. q: (B,1,H,Dh); cache_k/v: (B,S_max,KV,Dh);
    new_k/v: (B,1,KV,Dh) (already roped at ``pos``). ``pos`` is a 0-d
    tensor (whole batch at one position) or (B,) (the engine's
    mixed-length batches). Writes the new K/V into the caches in place
    and returns (out, cache_k, cache_v). ``shard_fn`` pins the
    reference's flash-decoding layout: where the reference constrains
    the expanded cache, this constrains the cache the grouped heads read,
    and its scores carry the KV and group dims in place of the heads."""
    b, s_max, kv, dh = cache_k.shape
    q = shard_fn(q, ("batch", "rep", "rep", "rep"))
    cache_k = shard_fn(cache_k, ("batch", "seq_model", "rep", "rep"))
    cache_v = shard_fn(cache_v, ("batch", "seq_model", "rep", "rep"))
    slot = pos % s_max if window > 0 else pos
    if pos.ndim == 0:
        cache_k.index_copy_(1, slot.reshape(1), new_k)
        cache_v.index_copy_(1, slot.reshape(1), new_v)
    else:
        rows = torch.arange(b, device=q.device)
        cache_k[rows, slot] = new_k[:, 0]
        cache_v[rows, slot] = new_v[:, 0]
    ck = shard_fn(cache_k, ("batch", "seq_model", "rep", "rep"))
    cv = shard_fn(cache_v, ("batch", "seq_model", "rep", "rep"))
    g = num_heads // kv
    scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(b, 1, kv, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.float()) * scale
    s = shard_fn(s, ("batch", "rep", "rep", "rep", "seq_model"))
    j = torch.arange(s_max, device=q.device)
    if window > 0:
        valid = ((pos[..., None] - j) % s_max) <= pos[..., None]   # rolling
    else:
        valid = j <= pos[..., None]
    # scalar pos -> (S,); vector pos -> (B,S)
    valid = valid.reshape(-1 if valid.ndim == 2 else 1, 1, 1, 1, s_max)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(cv.dtype).float(),
                       cv.float())
    out = out.reshape(b, 1, num_heads, dh).to(q.dtype)
    out = shard_fn(out, ("batch", None, "heads", None))   # late reshard
    return out, cache_k, cache_v
