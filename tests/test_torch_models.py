"""repro_torch dense model on qwen2-0.5b-reduced (f32) against the JAX
reference: the same params (JAX init, converted with
``repro_torch.models.convert``) and the same numpy-made inputs go through
``repro.models.api`` and ``repro_torch.models.api``.

Tolerance atol = rtol = 1e-4 on f32: the two frameworks sum in other
orders; nothing else differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import api as japi
from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.models.attention import attend_chunked
from repro_torch.models.common import ParamSpec, tree_paths
from repro_torch.models.convert import from_numpy_params

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-0.5b-reduced"


def _pair(window: int = 0):
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _pair()


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


def _prompts(rng, b, s, vocab):
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    lens = rng.integers(s // 2, s + 1, size=(b,)).astype(np.int32)
    lens[0] = s
    for i, n in enumerate(lens):
        toks[i, n:] = 0                   # right padding, as the engine does
    return toks, lens


def _teacher_forced(jcfg, tcfg, jp, tp, toks, lens, max_len, steps, seed):
    """Prefill then ``steps`` decode steps fed the same numpy tokens."""
    rng = np.random.default_rng(seed)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks),
                               "last_pos": jnp.asarray(lens - 1)}, jcfg)
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks).long(),
                              "last_pos": torch.as_tensor(lens - 1).long()},
                         tcfg)
    yield "prefill", jl, jc, tl, tc
    jc = japi.grow_cache(jcfg, jc, max_len)
    tc = api.grow_cache(tcfg, tc, max_len)
    pos = lens.copy()
    for i in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, size=(len(lens),)).astype(
            np.int32)
        jl, jc = japi.decode_step(jp, jc, {"token": jnp.asarray(tok),
                                           "pos": jnp.asarray(pos)}, jcfg)
        tl, tc = api.decode_step(tp, tc, {"token": torch.as_tensor(tok).long(),
                                          "pos": torch.as_tensor(pos).long()},
                                 tcfg)
        yield f"decode{i}", jl, jc, tl, tc
        pos = pos + 1


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_match_jax(window):
    """Prefill logits + KV cache, then 4 teacher-forced decode steps with
    per-row positions; ``window=8`` < prompt length drives the rolling
    cache (``to_rolling`` and the rolling decode mask)."""
    jcfg, tcfg, jp, tp = _pair(window)
    toks, lens = _prompts(np.random.default_rng(1), 3, 13,
                          tcfg.vocab_size)
    for _, jl, jc, tl, tc in _teacher_forced(jcfg, tcfg, jp, tp, toks, lens,
                                             32, 4, seed=2):
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def test_decode_with_scalar_pos_matches_jax(models):
    """The whole batch at one position (0-d ``pos``)."""
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(3).integers(0, 256, (2, 9)).astype(np.int32)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks).long()}, tcfg)
    _close(tl, jl)
    jc, tc = japi.grow_cache(jcfg, jc, 16), api.grow_cache(tcfg, tc, 16)
    for p in (9, 10):
        tok = np.array([5, 7], np.int32)
        jl, jc = japi.decode_step(jp, jc, {"token": jnp.asarray(tok),
                                           "pos": jnp.asarray(p)}, jcfg)
        tl, tc = api.decode_step(tp, tc, {"token": torch.as_tensor(tok).long(),
                                          "pos": torch.tensor(p)}, tcfg)
        _close(tl, jl)
        _close(tc["k"], jc["k"])


def test_prefill_attend_override_is_plain_chunked(models):
    """``attend=attend_chunked`` (the plain path the card run holds the
    kernel against) gives the default path's logits, at a length past
    the chunk size so the chunked loop runs."""
    _, tcfg, _, tp = models
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (1, 40)))
    a, ca = api.prefill(tp, {"tokens": toks}, tcfg)
    chunk = lambda q, k, v, **kw: attend_chunked(q, k, v, q_chunk=16,
                                                 kv_chunk=16, **kw)
    b, cb = api.prefill(tp, {"tokens": toks}, tcfg, attend=chunk)
    torch.testing.assert_close(a, b, **TOL)
    torch.testing.assert_close(ca["k"], cb["k"])


def test_cache_shapes_match_jax(models):
    jcfg, tcfg, _, _ = models
    jc = japi.init_cache(jcfg, 3, 20)
    tc = api.init_cache(tcfg, 3, 20, device="cpu")
    assert tc["k"].shape == jc["k"].shape and tc["v"].shape == jc["v"].shape
    assert tc["k"].dtype == torch.float32 and not tc["k"].any()


def test_param_tree_matches_jax_specs(models):
    jcfg, tcfg, jp, tp = models
    jpaths = {p: tuple(np.shape(x)) for p, x in
              [(".".join(str(k.key) for k in path), leaf) for path, leaf in
               jax.tree_util.tree_flatten_with_path(jp)[0]]}
    tpaths = {p: tuple(x.shape) for p, x in tree_paths(tp)}
    assert jpaths == tpaths
    assert tcfg.param_count() == jcfg.param_count()


def test_init_rule_and_seed():
    cfg = get_config(ARCH)
    a = api.init(torch.Generator().manual_seed(7), cfg, device="cpu")
    b = api.init(torch.Generator().manual_seed(7), cfg, device="cpu")
    c = api.init(torch.Generator().manual_seed(8), cfg, device="cpu")
    for (path, x), (_, y), (_, z) in zip(tree_paths(a), tree_paths(b),
                                         tree_paths(c)):
        assert torch.equal(x, y), path
    specs = dict(tree_paths(api.specs(cfg)))
    params = dict(tree_paths(a))
    for path, spec in specs.items():
        x = params[path]
        assert tuple(x.shape) == spec.shape and x.dtype == torch.float32
        if spec.init == "zeros":
            assert not x.any(), path
        elif spec.init == "ones":
            assert bool((x == 1).all()), path
        elif x.numel() > 1000:
            assert abs(float(x.std()) / (0.02 * spec.scale) - 1) < 0.1, path
    assert not torch.equal(params["embed.tok"],
                           dict(tree_paths(c))["embed.tok"])
    assert isinstance(specs["embed.tok"], ParamSpec)


def test_convert_carries_bf16_bit_patterns():
    x = np.random.default_rng(5).standard_normal((3, 7)).astype(np.float32)
    jb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))   # ml_dtypes bf16
    t = from_numpy_params({"w": jb}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    want = torch.from_numpy(x).to(torch.bfloat16)   # both round to even
    assert torch.equal(t, want)


def test_configs_resolve_and_unported_raise():
    full, red = get_config("qwen2-0.5b"), get_config(ARCH)
    ref = jax_config("qwen2-0.5b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qkv_bias", "rope_theta",
              "tie_embeddings", "param_dtype"):
        assert getattr(full, f) == getattr(ref, f), f
        assert getattr(red, f) == getattr(jax_config(ARCH), f), f
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # every reference id resolves; the encdec and vlm losses need the
    # stub frontends' frames or patches, which a tokens-only batch (all
    # the train data path makes, in the reference too) lacks
    for arch, key in (("whisper-tiny-reduced", "frames"),
                      ("llava-next-mistral-7b-reduced", "patches")):
        cfg = get_config(arch)
        params = api.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
        toks = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(KeyError, match=key):
            api.loss(params, {"tokens": toks, "labels": toks}, cfg)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No card and no explicit device='cpu': raise, never run on the CPU
    quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy_params({"w": np.zeros(2, np.float32)})
