"""The decoder-only families of repro_torch beyond qwen2-0.5b —
qwen1.5-4b, starcoder2-3b, qwen1.5-110b (dense) and mixtral-8x7b,
dbrx-132b (moe) — against the JAX reference on the CPU, each at its
``-reduced`` config (f32):

* the parameter tree equals ``repro.models.api.specs`` path for path and
  shape for shape, and the full config's ``param_count`` (and
  ``active_param_count``) equals the reference's;
* prefill logits and the whole cache, then two teacher-forced decode
  steps, against ``repro.models.api`` at atol = rtol = 1e-4 (the
  frameworks sum in other orders). Prompts are right-padded (``last_pos``)
  and the longest is 15 tokens, so mixtral's second decode step writes
  past its reduced window of 16 (the rolling cache wraps);
* starcoder2's loss and gradients on the dense train path (layernorm,
  the gelu MLP and its biases);
* the gelu MLP is the tanh form: swapping in PyTorch's erf form is
  caught;
* the stacked moe leaves and the gelu biases cross from the JAX tree
  unchanged, bf16 as its bit pattern.

The params are the JAX init plus seeded numpy noise on every leaf (so
biases and norms are not their constant init), converted with
``models/convert``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import TOL, assert_trees_close, close, model_pair

from repro.configs.registry import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.models import layers
from repro_torch.models.common import tree_from_paths, tree_paths
from repro_torch.models.convert import from_numpy_params

ARCHS = ("qwen1.5-4b", "starcoder2-3b", "qwen1.5-110b", "mixtral-8x7b",
         "dbrx-132b")
# the reference's param_count of each full config (bf16 size / 2 bytes)
PARAMS = {"qwen1.5-4b": 3_950_366_720, "starcoder2-3b": 3_180_622_848,
          "qwen1.5-110b": 111_209_906_176, "mixtral-8x7b": 46_702_788_608,
          "dbrx-132b": 131_596_517_376}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param + "-reduced", seed=2)


def _paths(tree) -> dict:
    return {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_counts_match_jax(arch):
    red = arch + "-reduced"
    assert {p: tuple(s.shape) for p, s in tree_paths(
        api.specs(get_config(red)))} == _paths(japi.specs(jax_config(red)))
    full, ref = get_config(arch), jax_config(arch)
    assert full.param_count() == ref.param_count() == PARAMS[arch]
    assert full.active_param_count() == ref.active_param_count()
    if full.family == "moe":
        assert full.active_param_count() < full.param_count()
        assert dataclasses.asdict(get_config(red).moe) == \
            dataclasses.asdict(jax_config(red).moe)


def _prompts(vocab):
    rng = np.random.default_rng(6)
    lens = np.array([15, 9], np.int32)
    toks = np.zeros((2, 15), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, lens


def test_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    toks, lens = _prompts(tcfg.vocab_size)
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray(lens - 1)})
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks).long(),
                              "last_pos": torch.as_tensor(lens - 1).long()},
                         tcfg)
    close(tl, jl, **TOL)
    assert_trees_close(tc, jc)
    jc, tc = japi.grow_cache(jcfg, jc, 24), api.grow_cache(tcfg, tc, 24)
    jdec = jax.jit(lambda p, c, b: japi.decode_step(p, c, b, jcfg))
    pos = lens.copy()
    for tok in ([3, 7], [11, 5]):
        tok = np.asarray(tok, np.int32)
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok),
                               "pos": jnp.asarray(pos)})
        tl, tc = api.decode_step(tp, tc, {
            "token": torch.as_tensor(tok).long(),
            "pos": torch.as_tensor(pos).long()}, tcfg)
        close(tl, jl, **TOL)
        assert_trees_close(tc, jc)
        pos = pos + 1
    if tcfg.sliding_window:
        assert pos[0] > tcfg.sliding_window     # the rolling cache wrapped


def test_starcoder2_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = model_pair("starcoder2-3b-reduced", seed=3)
    rng = np.random.default_rng(8)
    b = {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
         "labels": rng.integers(0, 256, (2, 16)).astype(np.int32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                             static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    leaves = {p: t.requires_grad_(True) for p, t in tree_paths(tp)}
    tl, taux = api.loss(tree_from_paths(leaves.items()),
                        {k: torch.as_tensor(v).long() for k, v in b.items()},
                        tcfg)
    tl.backward()
    close(tl.detach(), jl, **TOL)
    close(taux["aux"], jaux["aux"], **TOL)
    jgrads = dict((".".join(str(k.key) for k in path), g) for path, g in
                  jax.tree_util.tree_flatten_with_path(jg)[0])
    assert set(jgrads) == set(leaves) and "layers.mlp.bo" in jgrads
    for path, t in leaves.items():
        close(t.grad, jgrads[path], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("swap", [None, "erf_gelu"])
def test_mlp_gelu_swap_is_caught(swap, monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh approximation, PyTorch's
    ``F.gelu`` to the erf form. The MLP's input weights are scaled so
    the pre-activation spans a few units, where the two forms differ by
    up to ~5e-4, and its output weights so that difference reaches the
    output."""
    jcfg, tcfg, jp, tp = model_pair("starcoder2-3b-reduced", seed=1)
    scale = {"wi": 20.0, "wo": 100.0}
    jpl = {k: v[0] * scale.get(k, 1.0)
           for k, v in jp["layers"]["mlp"].items()}
    tpl = {k: v[0] * scale.get(k, 1.0)
           for k, v in tp["layers"]["mlp"].items()}
    if swap:
        real = F.gelu
        monkeypatch.setattr(F, "gelu", lambda x, approximate="none": real(x))
    x = np.random.default_rng(7).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jlayers.apply_mlp(jpl, jnp.asarray(x), "gelu")
    got = layers.apply_mlp(tpl, torch.from_numpy(x), "gelu")
    err = np.abs(got.numpy() - np.asarray(want)).max()
    if swap is None:
        assert err <= TOL["atol"] + TOL["rtol"] * np.abs(want).max(), err
    else:
        assert err > 10 * TOL["atol"], err


def test_unknown_kinds_raise():
    for fn, arg in ((layers.mlp_specs, (8, 16, "geglu", 1.0)),
                    (layers.norm_specs, (8, "batchnorm"))):
        with pytest.raises(ValueError, match="unknown"):
            fn(*arg)


@pytest.mark.parametrize("arch", ["mixtral-8x7b-reduced",
                                  "starcoder2-3b-reduced"])
def test_convert_carries_stacked_moe_and_gelu_leaves(arch):
    """The stacked moe leaves (router (L, d, E), wi/wg (L, E, d, f), wo
    (L, E, f, d)) and the gelu biases cross from the JAX tree unchanged,
    bf16 as its bit pattern."""
    jcfg = dataclasses.replace(jax_config(arch), param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(4), jcfg))
    jp = jax.tree.map(lambda a: a + np.asarray(0.01, a.dtype), jp)
    tp = from_numpy_params(jp, "cpu")
    want = dict(tree_paths(tp))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = want[".".join(str(k.key) for k in path)]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      leaf.view(np.int16))
    mlp = tp["layers"]["moe" if jcfg.family == "moe" else "mlp"]
    assert set(mlp) == ({"router", "wi", "wg", "wo"} if jcfg.family == "moe"
                        else {"wi", "bi", "wo", "bo"})
