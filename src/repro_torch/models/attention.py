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
back at its heads). Over a ``DeviceMesh`` the projections run on the
flattened weights with the heads split after the product
(``layers.even_reshape``), and decode writes the caller's cache at its
own placement through an explicit ``local_map`` (:func:`_write_slot`),
then reads a pinned copy.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.compat import torch_dtype
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import (ShardFn, as_dtensor, even_reshape,
                                       kept_shards, matmul, mesh_block,
                                       no_shard, rope)

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


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,D) x (D,H,Dh) -> (B,S,H,Dh): the product on the flattened
    (D, H*Dh) weight, the heads split after it through
    ``layers.even_reshape`` (over a mesh, DTensor's einsum would split them
    inside, where no gather can go). One path for plain tensors and
    DTensors, so a one-peer mesh computes what one peer does."""
    d, h, dh = w.shape
    y = matmul(x, even_reshape(w, (d, h * dh)))
    return even_reshape(y, (*y.shape[:-1], h, dh))


def project_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor,
                q_positions: torch.Tensor, kv_positions: torch.Tensor,
                rope_theta: float, shard_fn: ShardFn = no_shard):
    """Returns q (B,Sq,H,Dh), k/v (B,Skv,KV,Dh); RoPE applied to q and k."""
    dt = xq.dtype
    q = _project(xq, p["wq"].to(dt))
    k = _project(xkv, p["wk"].to(dt))
    v = _project(xkv, p["wv"].to(dt))
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
    wo = p["wo"].to(attn.dtype)
    h, dh, d = wo.shape                 # as in _project
    out = matmul(even_reshape(attn, (*attn.shape[:-2], h * dh)),
                 even_reshape(wo, (h * dh, d)))
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
    p % window. Pads when S < window. A DTensor ``k`` is rolled on each
    peer's local blocks (its batch and KV-head split kept, the length
    whole) through an explicit ``local_map``: torch 2.11's DTensor pads
    into a malformed DTensor (one placement on a 2-D mesh)."""
    if isinstance(k, DTensor):
        pl = kept_shards(k, (0, 2))
        return local_map(lambda t: to_rolling(t, window), out_placements=pl,
                         in_placements=(pl,), device_mesh=k.device_mesh,
                         redistribute_inputs=True)(k)
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


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> None:
    """``cache[:, slot] = new[:, 0]`` IN PLACE, at the cache's own
    placement: ``cache`` (B,S,KV,Dh), ``new`` (B,1,KV,Dh), ``slot`` 0-d
    (every row) or (B,). A DTensor cache is written through an explicit
    ``local_map`` (DTensor's ``index_copy_`` re-places the cache): each
    peer writes the rows it holds, into its own block of the length,
    where the slot falls in that block's range (a masked write of the
    old value elsewhere, so nothing waits on the slot's value)."""
    if not isinstance(cache, DTensor):
        if slot.ndim == 0:
            cache.index_copy_(1, slot.reshape(1), new)
        else:
            rows = torch.arange(cache.shape[0], device=cache.device)
            cache[rows, slot] = new[:, 0]
        return
    mesh = cache.device_mesh
    c_pl = list(cache.placements)
    if any(not isinstance(p, (Shard, Replicate)) for p in c_pl):
        raise ValueError(f"a KV cache at {c_pl} is not a stored value")
    length = [i for i, p in enumerate(c_pl) if p == Shard(1)]
    block, n = mesh_block(mesh, length)
    lo = block * (cache.shape[1] // n)
    new_pl = [Replicate() if i in length else p for i, p in enumerate(c_pl)]
    slot_pl = [p if slot.ndim and p == Shard(0) else Replicate()
               for p in c_pl]

    def write(c, nw, sl):
        local = sl - lo
        inside = (local >= 0) & (local < c.shape[1])
        idx = local.clamp(0, c.shape[1] - 1)
        if sl.ndim == 0:
            idx = idx.reshape(1)
            c.index_copy_(1, idx, torch.where(inside, nw,
                                              c.index_select(1, idx)))
        else:
            rows = torch.arange(c.shape[0], device=c.device)
            c[rows, idx] = torch.where(inside[:, None, None], nw[:, 0],
                                       c[rows, idx])
        return c

    local_map(write, out_placements=c_pl, in_placements=(c_pl, new_pl,
                                                         slot_pl),
              device_mesh=mesh, redistribute_inputs=True)(
        cache, new, as_dtensor(slot, mesh))


def decode_attend(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, new_k: torch.Tensor,
                  new_v: torch.Tensor, pos: torch.Tensor, *,
                  num_heads: int, window: int = 0,
                  shard_fn: ShardFn = no_shard):
    """Single-token decode. q: (B,1,H,Dh); cache_k/v: (B,S_max,KV,Dh);
    new_k/v: (B,1,KV,Dh) (already roped at ``pos``). ``pos`` is a 0-d
    tensor (whole batch at one position) or (B,) (the engine's
    mixed-length batches). Writes the new K/V into the caller's caches
    in place, at their own placement (:func:`_write_slot`), and returns
    (out, cache_k, cache_v): the caller's cache objects. ``shard_fn``
    pins the reference's flash-decoding layout on a copy of the written
    caches: where the reference constrains the expanded cache, this
    constrains the cache the grouped heads read, and its scores carry
    the KV and group dims in place of the heads. The scores stay
    length-sharded, but DTensor has no reduction form of the softmax
    over a sharded dim: it gathers the (B,KV,G,1,S) scores over the
    length's mesh dims where the reference's softmax max and sum are
    small reductions (the cache itself is never gathered)."""
    b, s_max, kv, dh = cache_k.shape
    q = shard_fn(q, ("batch", "rep", "rep", "rep"))
    slot = pos % s_max if window > 0 else pos
    _write_slot(cache_k, new_k, slot)
    _write_slot(cache_v, new_v, slot)
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
