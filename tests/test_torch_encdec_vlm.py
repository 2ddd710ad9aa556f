"""The encdec (whisper-tiny) and vlm (llava-next-mistral-7b) families of
repro_torch against the JAX reference on the CPU, each at its
``-reduced`` config (f32):

* the parameter tree equals ``repro.models.api.specs`` path for path and
  shape for shape, and the full config's ``param_count`` equals the
  reference's;
* whisper's encoder (non-causal attention through the kernel's plain
  version) against ``repro.models.whisper.encode``;
* prefill logits and the whole cache (whisper's ``self``, ``cross_k``,
  ``cross_v``; llava's prefix slots), then two teacher-forced decode
  steps, at atol = rtol = 1e-4 (the frameworks sum in other orders), on
  right-padded prompts with ``last_pos``. The reference reads an encdec
  prompt's first token at the padded batch's last position and a vlm
  prompt's at row ``last_pos`` of the prefixed sequence; the port does
  the same, and reading each prompt's own last token instead is caught;
* greedy tokens served through ``make_engine_group`` equal the JAX
  group's, with more requests than decode slots, so that admission
  writes the (nested) cache rows.

Frames and patches are seeded random embeddings here (the engine feeds
zeros, as the reference's does). The params are the JAX init plus
seeded numpy noise on every leaf, converted with ``models/convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (TOL, assert_trees_close, close, model_pair,
                          requests, served_tokens)

from repro.configs.registry import get_config as jax_config
from repro.models import api as japi
from repro.models import whisper as jwhisper
from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.models import whisper
from repro_torch.models.common import tree_paths

ARCHS = ("whisper-tiny", "llava-next-mistral-7b")
# the reference's param_count of each full config
PARAMS = {"whisper-tiny": 56_368_896, "llava-next-mistral-7b": 7_241_728_000}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param + "-reduced", seed=3)


def _paths(tree) -> dict:
    return {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_counts_match_jax(arch):
    red = arch + "-reduced"
    got = {p: tuple(s.shape) for p, s in tree_paths(
        api.specs(get_config(red)))}
    assert got == _paths(japi.specs(jax_config(red)))
    full, ref = get_config(arch), jax_config(arch)
    assert full.param_count() == ref.param_count() == PARAMS[arch]
    for f in ("encoder_layers", "num_frames", "num_patches", "rope_theta",
              "num_kv_heads", "head_dim"):
        assert getattr(full, f) == getattr(ref, f), f
        assert getattr(get_config(red), f) == getattr(jax_config(red), f), f


def _inputs(cfg, seed=6):
    """Two right-padded prompts (11 and 6 tokens) and the stub
    frontend's embeddings, random."""
    rng = np.random.default_rng(seed)
    lens = np.array([11, 6], np.int32)
    toks = np.zeros((2, 11), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    n = cfg.num_frames if cfg.family == "encdec" else cfg.num_patches
    emb = rng.normal(size=(2, n, cfg.d_model)).astype(np.float32)
    name = "frames" if cfg.family == "encdec" else "patches"
    jb = {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray(lens - 1),
          name: jnp.asarray(emb)}
    tb = {"tokens": torch.as_tensor(toks).long(),
          "last_pos": torch.as_tensor(lens - 1).long(),
          name: torch.from_numpy(emb)}
    return jb, tb, lens


def test_encode_matches_jax():
    jcfg, tcfg, jp, tp = model_pair("whisper-tiny-reduced", seed=4)
    frames = np.random.default_rng(2).normal(
        size=(2, tcfg.num_frames, tcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, f: jwhisper.encode(p, f, jcfg))(
        jp, jnp.asarray(frames))
    got = whisper.encode(tp, torch.from_numpy(frames), tcfg)
    close(got, want, **TOL)


def test_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    jb, tb, lens = _inputs(tcfg)
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg))(jp, jb)
    tl, tc = api.prefill(tp, tb, tcfg)
    close(tl, jl, **TOL)
    assert_trees_close(tc, jc)
    if tcfg.family == "encdec":
        assert sorted(tc) == ["cross_k", "cross_v", "self"]
        assert tc["cross_k"].shape[2] == tcfg.num_frames
    else:
        assert tc["k"].shape[2] == tcfg.num_patches + tb["tokens"].shape[1]
    jc, tc = japi.grow_cache(jcfg, jc, 24), api.grow_cache(tcfg, tc, 24)
    assert_trees_close(tc, jc)
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


def test_first_token_rows_are_the_references(pair):
    """The quirks: the reference's prefill logits of the shorter prompt
    are NOT those of its own last token — the padded batch's last
    position for encdec, patch row ``last_pos`` for vlm — and reading
    the prompt's own last token instead misses them."""
    jcfg, tcfg, jp, tp = pair
    jb, tb, lens = _inputs(tcfg)
    want = np.asarray(jax.jit(lambda p, b: japi.prefill(p, b, jcfg))(
        jp, jb)[0])
    if tcfg.family == "encdec":
        # each prompt alone, unpadded: its own last token; the longest
        # prompt's is the batch's last position
        own = torch.cat([api.prefill(tp, {
            "tokens": tb["tokens"][i:i + 1, :lens[i]],
            "frames": tb["frames"][i:i + 1]}, tcfg)[0] for i in range(2)])
        close(own[0], want[0], **TOL)
        missed = [1]
    else:
        own = api.prefill(tp, dict(tb, last_pos=tb["last_pos"]
                                   + tcfg.num_patches), tcfg)[0]
        missed = [0, 1]
    for row in missed:
        assert np.abs(own[row].numpy() - want[row]).max() > 100 * TOL["atol"]
    close(api.prefill(tp, tb, tcfg)[0], want, **TOL)


def test_decode_with_scalar_pos_matches_jax(pair):
    """The whole batch at one position (0-d ``pos``: whisper's
    ``pos_dec`` row and llava's prefix offset)."""
    jcfg, tcfg, jp, tp = pair
    jb, tb, _ = _inputs(tcfg)
    jb.pop("last_pos")
    tb.pop("last_pos")
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg))(jp, jb)
    tl, tc = api.prefill(tp, tb, tcfg)
    jc, tc = japi.grow_cache(jcfg, jc, 16), api.grow_cache(tcfg, tc, 16)
    tok = np.array([5, 7], np.int32)
    jl, jc = jax.jit(lambda p, c, b: japi.decode_step(p, c, b, jcfg))(
        jp, jc, {"token": jnp.asarray(tok), "pos": jnp.asarray(11)})
    tl, tc = api.decode_step(tp, tc, {"token": torch.as_tensor(tok).long(),
                                      "pos": torch.tensor(11)}, tcfg)
    close(tl, jl, **TOL)
    assert_trees_close(tc, jc)


def test_init_cache_matches_jax(pair):
    jcfg, tcfg, _, _ = pair
    jc = japi.init_cache(jcfg, 3, 20)
    tc = api.init_cache(tcfg, 3, 20, device="cpu")
    assert {p: tuple(t.shape) for p, t in tree_paths(tc)} == _paths(jc)
    assert all(not t.any() for _, t in tree_paths(tc))


def test_stub_inputs_are_the_reference_engines():
    """Zero frames (B, num_frames, D) for encdec, zero patches (B,
    num_patches, D) for vlm, in the compute dtype; none for the rest."""
    for arch, name in (("whisper-tiny", "frames"),
                       ("llava-next-mistral-7b", "patches")):
        cfg = get_config(arch)
        got = api.stub_inputs(cfg, 2, "cpu")
        n = cfg.num_frames if name == "frames" else cfg.num_patches
        assert list(got) == [name]
        assert got[name].shape == (2, n, cfg.d_model)
        assert got[name].dtype == torch.bfloat16 and not got[name].any()
    assert api.stub_inputs(get_config("qwen2-0.5b"), 2, "cpu") == {}


def test_served_tokens_match_jax(pair):
    """6 requests on 2 loops of 2 slots: each loop admits its third
    request into a freed slot (whisper's nested cache included)."""
    jcfg, tcfg, jp, tp = pair
    reqs = requests([9, 4, 13, 6, 11, 5], [3, 5], seed=7)
    want, got, group = served_tokens(jcfg, tcfg, jp, tp, reqs)
    assert got == want
    assert all(len(t) == m for t, (_, _, m) in zip(got, reqs))
    assert sum(l.engine.admit_prefills for l in group.loops) > 0
