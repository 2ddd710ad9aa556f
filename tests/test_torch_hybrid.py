"""repro_torch's hybrid (recurrentgemma) slice against the JAX reference
on the CPU, and its CUDA RG-LRU kernel and the flash kernel at head_dim
256 against their plain versions on the card.

* ``ops.rglru`` (on CPU tensors: the plain step loop) against the JAX
  ``repro.kernels.ops.rglru`` (the Pallas kernel in interpret mode) and
  ``repro.kernels.ref.rglru`` (an associative scan) at the reference
  suite's shapes and its 2e-4, and the model's RG-LRU core against the
  reference model's.
* ``recurrentgemma-9b-reduced`` (f32; 6 layers = two groups, no tail) and
  the same at ``num_layers=8`` (two ``tail*`` rglru entries, batch at
  axis 0): prefill logits, the whole cache tree and 4 teacher-forced
  decode steps that run past ``local_window=16`` against
  ``repro.models.api``, atol = rtol = 1e-4 (sums in other orders). The
  params are the JAX init plus seeded numpy noise on every leaf.
* Served greedy tokens equal the JAX group's; cache batch axes and the
  full config's parameter count are the reference's; the gelu of the
  gate is the tanh form (the erf form is caught).

On the card machine (no JAX there) run the kernel tests alone:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_hybrid.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import (TOL, assert_trees_close, close, model_pair,
                          requests, served_tokens, teacher_forced)

from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import rglru as _rg
from repro_torch.models import api
from repro_torch.models import hybrid as thyb
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.serving import cache_layout, dispatch

try:                          # the card's machine has no JAX installed
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import api as japi
    from repro.models import hybrid as jhyb
    from repro.serving import cache_layout as jlayout
except ImportError:
    jax = None

ARCH = "recurrentgemma-9b-reduced"
SCAN_TOL = (2e-4, 2e-4)


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def scan_inputs(b, t, w, seed):
    """a in (0, 0.95) as the reference's kernel tests draw it; b, h0
    standard normal."""
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    a = (1 / (1 + np.exp(-n(b, t, w))) * 0.95).astype(np.float32)
    return a, n(b, t, w), n(b, w)


# -- (a) the scan against the JAX kernel, oracle and model -------------------


@pytest.mark.parametrize("b,t,w", [(2, 64, 128), (1, 100, 65), (3, 16, 512)])
def test_rglru_matches_jax(b, t, w, jax_ref):
    args = scan_inputs(b, t, w, seed=t + w)
    y, hf = ops.rglru(*(torch.from_numpy(a) for a in args))
    assert y.shape == (b, t, w) and hf.shape == (b, w)
    jy, jhf = jops.rglru(*(jnp.asarray(a) for a in args))
    ry, rhf = jref.rglru(*(jnp.asarray(a) for a in args))
    for got, want in ((y, jy), (hf, jhf), (y, ry), (hf, rhf)):
        close(got, want, *SCAN_TOL)


@pytest.mark.parametrize("t", [1, 48])
def test_rglru_core_matches_model(t, jax_ref):
    """The port's ``_rglru`` (gates, then ``ops.rglru`` for T>1 or the
    one-line step for T=1) against the reference model's core."""
    b, lw, nb = 2, 64, 4
    rng = np.random.default_rng(t)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    p = {"wa": n(nb, lw // nb, lw // nb) * 0.1, "ba": n(lw) * 0.1,
         "wx": n(nb, lw // nb, lw // nb) * 0.1, "bx": n(lw) * 0.1,
         "lam": 1 + n(lw) * 0.1}
    y, h0 = n(b, t, lw), n(b, lw) * 0.1
    core = jax.jit(jhyb._rglru, static_argnums=(3, 4))
    jh, jlast = core(jnp.asarray(y), jax.tree.map(jnp.asarray, p),
                     jnp.asarray(h0), nb, lw // nb)
    th, tlast = thyb._rglru(torch.from_numpy(y),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(h0), nb, lw // nb, ops.rglru)
    close(th, jh, *SCAN_TOL)
    close(tlast, jlast, *SCAN_TOL)


def test_cpu_path_launches_no_kernel():
    args = [torch.from_numpy(a) for a in scan_inputs(1, 7, 9, seed=1)]
    before = ops.rglru.launches
    ops.rglru(*args)
    assert ops.rglru.launches == before and "rglru" not in build.BUILD_INFO


def test_rglru_rejects_bad_inputs():
    a, b, h0 = (torch.from_numpy(x) for x in scan_inputs(1, 4, 8, seed=2))
    with pytest.raises(ValueError, match="shape"):
        ops.rglru(a, b[:, :2], h0)
    with pytest.raises(ValueError, match="h0"):
        ops.rglru(a, b, h0[:, :3])
    with pytest.raises(ValueError, match="float32"):
        ops.rglru(a.double(), b, h0)


# -- (b) the model against repro.models.api ----------------------------------


@pytest.fixture(scope="module", params=[6, 8], ids=["reduced", "tail"])
def hybrid(request, jax_ref):
    """reduced (6 layers: two groups) and 8 layers (two tail rglru)."""
    return model_pair(ARCH, num_layers=request.param)


@pytest.mark.parametrize("prompt", [13, 19])
def test_prefill_cache_and_decode_match_jax(hybrid, prompt):
    """4 decode steps from 13 (positions 13..16) and from 19 (a prefill
    past the window): both run past local_window=16, so the rolling
    pages wrap."""
    jcfg, tcfg, jp, tp = hybrid
    toks = np.random.default_rng(prompt).integers(0, 256, (2, prompt)
                                                  ).astype(np.int32)
    for jl, jc, tl, tc in teacher_forced(jcfg, tcfg, jp, tp, toks, 4,
                                         seed=2):
        close(tl, jl, **TOL)
        assert_trees_close(tc, jc)
    tails = [k for k in tc if k.startswith("tail")]
    assert tails == ([] if tcfg.num_layers == 6
                     else ["tail0_rglru", "tail1_rglru"])


def test_kernels_on_the_path(hybrid, monkeypatch):
    """A prefill runs one ``ops.rglru`` per rglru layer and one
    ``ops.flash_attention`` per local-attention layer; a decode step
    runs neither (the one-line update, the cache attention). ``scan`` and
    ``attend`` with the plain versions give the same logits."""
    _, tcfg, _, tp = hybrid
    seen = []

    def spy(name, fn):
        def run(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(ops, "rglru", spy("rglru", ref.rglru))
    monkeypatch.setattr(ops, "flash_attention",
                        spy("flash", ref.flash_attention))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 9)))
    logits, cache = api.prefill(tp, {"tokens": toks}, tcfg)
    n_rec = sum(tcfg.block_pattern[i % 3] == "rglru"
                for i in range(tcfg.num_layers))
    assert sorted(seen) == ["flash"] * (tcfg.num_layers - n_rec) \
        + ["rglru"] * n_rec
    seen.clear()
    api.decode_step(tp, cache, {"token": toks[:, 0],
                                "pos": torch.tensor([9, 9])}, tcfg)
    assert seen == []
    monkeypatch.undo()
    plain, _ = api.prefill(tp, {"tokens": toks}, tcfg, scan=ref.rglru,
                           attend=ref.flash_attention)
    torch.testing.assert_close(plain, logits, rtol=0, atol=0)


# -- (c) served tokens against the JAX group ---------------------------------


def test_served_tokens_match_jax(hybrid):
    """Equal-length pairs, one per loop, plus one odd length; prompts of
    18 and 11 plus 5 new tokens cross the 16-slot window in decode."""
    jcfg, tcfg, jp, tp = hybrid
    reqs = requests([18, 11, 18, 11, 7], [5, 4], seed=5)
    want, got, tg = served_tokens(jcfg, tcfg, jp, tp, reqs)
    assert got == want
    assert [len(t) for t in got] == [m for _, _, m in reqs]
    assert sum(l.engine.admit_prefills for l in tg.loops) == 0


def test_gathering_write_path_matches_local_path(hybrid):
    """With a channel affinity the step carves the prefill result by the
    mixed batch axes (``groups`` at 1, ``tail*`` at 0); at ring size 1 it
    equals the local path exactly."""
    _, tcfg, _, tp = hybrid
    local = dispatch.make_serve_step(tcfg, CommConfig())
    wired = dispatch.make_serve_step(tcfg, CommConfig(),
                                     channel_indices=(0, 1))
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(4).integers(0, 256, (2, 11)))}
    la, ca = local.prefill(tp, batch)
    lb, cb = wired.prefill(tp, batch)
    assert torch.equal(la, lb)
    for (pa, a), (pb, b) in zip(tree_paths(ca), tree_paths(cb)):
        assert pa == pb and torch.equal(a, b), pa


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_expand_kv_is_dense_for_the_kernel(kv):
    """The flash kernel takes only contiguous q/k/v. With one KV head
    (recurrentgemma's MQA) the expanded keys were a stride-0 view, which
    the CPU path accepts and the card refused."""
    from repro_torch.models.attention import expand_kv
    k = torch.randn(2, 5, kv, 8)
    x = expand_kv(k, 4)
    assert x.shape == (2, 5, 4, 8) and x.is_contiguous()
    torch.testing.assert_close(x[:, :, 3], k[:, :, 3 // (4 // kv)])


# -- (d), (e) layout and sizes -----------------------------------------------


def test_batch_axes_and_param_count_match_jax(hybrid):
    jcfg, tcfg, _, tp = hybrid
    tc = api.init_cache(tcfg, 3, 16, device="cpu")
    jc = japi.init_cache(jcfg, 3, 16)
    assert_trees_close(tc, jc, dict(atol=0, rtol=0))
    axes = cache_layout.batch_axes("hybrid", tc)
    assert axes == jlayout.batch_axes("hybrid", jc)
    assert (0 in axes) == (tcfg.num_layers == 8)
    assert sorted(p for p, _ in tree_paths(tp)) == sorted(
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(japi.init(
            jax.random.PRNGKey(0), jcfg))[0])
    for arch in ("recurrentgemma-9b", ARCH):
        assert get_config(arch).param_count() == \
            jax_config(arch).param_count()
    assert get_config("recurrentgemma-9b").param_count() == 9_681_510_400


# -- (f) the gate's gelu is the tanh form ------------------------------------


@pytest.mark.parametrize("swap", [None, "erf_gelu"])
def test_gate_gelu_swap_is_caught(swap, jax_ref, monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh approximation; PyTorch's
    default is the erf form. The block parity check sees the swap: the
    gate weights are scaled so the gate spans a few units, where the two
    forms differ by up to ~5e-4, and the input and output projections so
    that difference reaches the block's output."""
    jcfg, tcfg, jp, tp = model_pair(ARCH, seed=1)
    jpl = jax.tree.map(lambda a: a[0], jp["layers"]["groups"]["b0_rglru"])
    tpl = tree_map(lambda a: a[0], tp["layers"]["groups"]["b0_rglru"])
    scale = {"w_gate": 40.0, "w_in": 10.0, "w_out": 100.0}
    jpl = dict(jpl, **{k: jpl[k] * f for k, f in scale.items()})
    tpl = dict(tpl, **{k: tpl[k] * f for k, f in scale.items()})
    if swap:
        real = F.gelu
        monkeypatch.setattr(F, "gelu", lambda x, approximate="none": real(x))
    x = np.random.default_rng(7).standard_normal((2, 5, 64)).astype(
        np.float32)
    lw = jcfg.lru_width
    jst = {"h": jnp.zeros((2, lw)), "conv": jnp.zeros((2, 3, lw))}
    want, _ = jhyb.apply_recurrent_block(jpl, jnp.asarray(x), jcfg,
                                         shard_fn=lambda a, _: a, state=jst)
    tst = {"h": torch.zeros((2, lw)), "conv": torch.zeros((2, 3, lw))}
    got, _ = thyb.apply_recurrent_block(tpl, torch.from_numpy(x), tcfg,
                                        state=tst, scan=ref.rglru)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    if swap is None:
        assert err <= TOL["atol"] + TOL["rtol"] * np.abs(want).max(), err
    else:
        assert err > 10 * TOL["atol"], err


# -- (g) the CUDA kernels on the card ----------------------------------------


LCH = _rg.CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("t", sorted({1, 7, 8, 9, 100, LCH, LCH + 1, 1024}))
@pytest.mark.parametrize("w", [1, 65, 4096 + 3, 4096, 7, 4 * 1025])
def test_kernel_matches_plain_on_card(t, w, cuda):
    """Both load paths: W % 4 == 0 loads by TMA, any other W by cp.async;
    T on both sides of the tile length; one launch per call."""
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(3, t, w, seed=t * w)]
    assert _rg.load_path(*args[:2]) == ("tma" if w % 4 == 0 else "cp.async")
    before = ops.rglru.launches
    y, hf = ops.rglru(*args)
    torch.cuda.synchronize()
    assert ops.rglru.launches == before + 1
    ry, rhf = ref.rglru(*args)
    close(y.cpu(), ry.cpu(), *SCAN_TOL)
    close(hf.cpu(), rhf.cpu(), *SCAN_TOL)


@pytest.mark.cuda
def test_kernel_at_the_model_shape_on_card(cuda):
    """recurrentgemma-9b's prefill shape (B=2, T=1024, W=4096)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(2, 1024, 4096, seed=11)]
    y, hf = ops.rglru(*args)
    torch.cuda.synchronize()
    ry, rhf = ref.rglru(*args)
    close(y.cpu(), ry.cpu(), *SCAN_TOL)
    close(hf.cpu(), rhf.cpu(), *SCAN_TOL)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_run(cuda):
    a, b, h0 = (torch.from_numpy(x).to(cuda)
                for x in scan_inputs(2, 4, 8, seed=3))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru(a.transpose(0, 1).contiguous().transpose(0, 1), b, h0)
    a.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rglru(a, b, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", (2e-4, 2e-3)),
                                       ("bfloat16", (3e-2, 5e-2))])
@pytest.mark.parametrize("s,window", [(100, 0), (257, 48), (1024, 2048)])
def test_flash_head_dim_256_on_card(dtype, tol, s, window, cuda):
    """The flash kernel at recurrentgemma's head_dim 256 (16 heads), at
    the flash tests' tolerances."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 16, 256)).astype(
        np.float32)).to(cuda, getattr(torch, dtype)) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    close(got.float().cpu(), want.float().cpu(), *tol)


def chained_rglru(device, t1, t2, w, seed):
    """rglru over T, then over T' from its last state: (h_seq, h_final)
    over the T + T' steps, and the numpy inputs of all of them."""
    args = scan_inputs(2, t1 + t2, w, seed=seed)
    a, b, h0 = (torch.from_numpy(x).to(device) for x in args)
    part = lambda x, sl: x[:, sl].contiguous()
    y1, h1 = ops.rglru(part(a, slice(0, t1)), part(b, slice(0, t1)), h0)
    y2, h2 = ops.rglru(part(a, slice(t1, None)), part(b, slice(t1, None)),
                       h1)
    return (torch.cat([y1, y2], 1), h2), args


@pytest.mark.parametrize("t1,t2,w", [(LCH, LCH + 1, 64), (9, 1, 65)])
def test_chained_rglru_matches_one_call(t1, t2, w, jax_ref):
    """The plain path (CPU tensors), resumed from its last state, against
    the JAX oracle over all T + T' steps in one call."""
    (y, h), args = chained_rglru("cpu", t1, t2, w, seed=t1 * w)
    jy, jhf = jref.rglru(*(jnp.asarray(a) for a in args))
    close(y, jy, *SCAN_TOL)
    close(h, jhf, *SCAN_TOL)


@pytest.mark.cuda
def test_kernel_chunk_matches_launcher(cuda):
    assert _rg.kernel_chunk() == _rg.CHUNK


@pytest.mark.cuda
def test_kernel_misaligned_base_takes_cp_async_on_card(cuda):
    """W = 4096 but a and b 4 bytes past a 16-byte boundary: no tensor map
    can describe them, so the same call loads by cp.async."""
    a, b, h0 = (torch.from_numpy(x).to(cuda)
                for x in scan_inputs(2, LCH + 1, 4096, seed=5))
    buf = torch.empty(2 * a.numel() + 1, device=cuda)
    a_off = buf[1:1 + a.numel()].view_as(a)
    b_off = buf[1 + a.numel():].view_as(b)
    a_off.copy_(a)
    b_off.copy_(b)
    assert _rg.load_path(a_off, b_off) == "cp.async"
    y, hf = ops.rglru(a_off, b_off, h0)
    torch.cuda.synchronize()
    ry, rhf = ref.rglru(a, b, h0)
    close(y.cpu(), ry.cpu(), *SCAN_TOL)
    close(hf.cpu(), rhf.cpu(), *SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t1,t2,w", [(LCH, LCH + 1, 4096), (9, 1, 65),
                                     (1024, 9, 4099)])
def test_kernel_chained_rglru_matches_one_call_on_card(t1, t2, w, cuda):
    (y, h), args = chained_rglru(cuda, t1, t2, w, seed=t1 * w)
    yw, hw = ops.rglru(*(torch.from_numpy(a).to(cuda) for a in args))
    torch.cuda.synchronize()
    close(y.cpu(), yw.cpu(), *SCAN_TOL)
    close(h.cpu(), hw.cpu(), *SCAN_TOL)
