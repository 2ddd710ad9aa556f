"""repro_torch's rwkv6 slice against the JAX reference on the CPU, and its
CUDA WKV6 kernel against its plain version on the card.

* ``ops.wkv6`` (on CPU tensors: the plain step loop) against the JAX
  ``repro.kernels.ops.wkv6`` (the Pallas kernel in interpret mode, as
  tests/test_kernels.py runs it) and ``repro.kernels.ref.wkv6``, at the
  reference suite's shapes and tolerances: 2e-3 (the chunked log-space
  kernel regroups the products), 5e-3 at extreme decays.
* ``rwkv6-7b-reduced`` (f32): prefill logits, the whole state tree and 4
  teacher-forced decode steps against ``repro.models.api``, atol = rtol =
  1e-4 (the frameworks sum in other orders; nothing else differs). The
  params are the JAX init plus seeded numpy noise on every leaf, so the
  zero-initialised mixes, decay base and bonus ``u`` carry weight.
* Served greedy tokens of the port's event-loop group equal the JAX
  group's; the cache layout and the full config's parameter count are
  the reference's.

On the card machine (no JAX there) run the kernel tests alone:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_rwkv6.py``.
"""
import numpy as np
import pytest
import torch

from torch_parity import (TOL, assert_trees_close, close, model_pair,
                          requests, served_tokens, teacher_forced)

from repro_torch.configs.registry import get_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import rwkv6_scan as _wk
from repro_torch.models import api
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.models.layers import apply_norm
from repro_torch.serving import cache_layout

try:                          # the card's machine has no JAX installed
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import api as japi
    from repro.models.layers import apply_norm as japply_norm
    from repro.serving import cache_layout as jlayout
except ImportError:
    jax = None

ARCH = "rwkv6-7b-reduced"
SCAN_SHAPES = [(2, 64, 2, 16), (1, 37, 3, 32), (1, 128, 1, 64)]


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


def scan_inputs(b, t, h, hs, seed, extreme=False):
    """r, k, v, w, u, s0 as the reference's kernel tests draw them:
    decays in (0.1, 0.95), or half 1e-6 and half 1 - 1e-6."""
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    r, k, v = n(b, t, h, hs), n(b, t, h, hs), n(b, t, h, hs)
    if extreme:
        w = np.concatenate([np.full((b, t // 2, h, hs), 1e-6, np.float32),
                            np.full((b, t - t // 2, h, hs), 1 - 1e-6,
                                    np.float32)], axis=1)
    else:
        w = (1 / (1 + np.exp(-n(b, t, h, hs))) * 0.85 + 0.1).astype(
            np.float32)
    return r, k, v, w, n(h, hs) * 0.1, n(b, h, hs, hs) * 0.1


# -- (a) the scan against the JAX kernel and oracle --------------------------


@pytest.mark.parametrize("b,t,h,hs", SCAN_SHAPES)
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_matches_jax(b, t, h, hs, chunk, jax_ref):
    args = scan_inputs(b, t, h, hs, seed=t + hs)
    y, sf = ops.wkv6(*(torch.from_numpy(a) for a in args))
    assert y.dtype == torch.float32 and y.shape == (b, t, h, hs)
    jy, jsf = jops.wkv6(*(jnp.asarray(a) for a in args), chunk=chunk)
    ry, rsf = jref.wkv6(*(jnp.asarray(a) for a in args))
    for got, want in ((y, jy), (sf, jsf), (y, ry), (sf, rsf)):
        close(got, want, 2e-3, 2e-3)


def test_wkv6_extreme_decay_matches_jax(jax_ref):
    args = scan_inputs(1, 32, 1, 16, seed=7, extreme=True)
    args = args[:5] + (np.zeros_like(args[5]),)
    y, sf = ops.wkv6(*(torch.from_numpy(a) for a in args))
    jy, jsf = jops.wkv6(*(jnp.asarray(a) for a in args), chunk=16)
    assert np.isfinite(y.numpy()).all()
    close(y, jy, 5e-3, 5e-3)
    close(sf, jsf, 5e-3, 5e-3)


def test_cpu_path_launches_no_kernel():
    args = [torch.from_numpy(a) for a in scan_inputs(1, 5, 2, 16, seed=1)]
    before = ops.wkv6.launches
    y, _ = ops.wkv6(*args)
    assert ops.wkv6.launches == before and "rwkv6_scan" not in build.BUILD_INFO
    torch.testing.assert_close(y, ref.wkv6(*args)[0], rtol=0, atol=0)


def test_wkv6_rejects_bad_inputs():
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in scan_inputs(1, 4, 2, 16, seed=2))
    with pytest.raises(ValueError, match="shape"):
        ops.wkv6(r, k[:, :2], v, w, u, s0)
    with pytest.raises(ValueError, match="u"):
        ops.wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6(r.double(), k, v, w, u, s0)


# -- (b) the model against repro.models.api ----------------------------------


@pytest.fixture(scope="module")
def rwkv(jax_ref):
    return model_pair(ARCH)


def test_prefill_state_and_decode_match_jax(rwkv):
    jcfg, tcfg, jp, tp = rwkv
    toks = np.random.default_rng(1).integers(0, 256, (3, 13)).astype(np.int32)
    for jl, jc, tl, tc in teacher_forced(jcfg, tcfg, jp, tp, toks, 4, seed=2):
        close(tl, jl, **TOL)
        assert_trees_close(tc, jc)


def test_every_scan_goes_through_ops_wkv6(rwkv, monkeypatch):
    """Prefill runs one T=S scan per layer, decode one T=1 scan per
    layer, all through ``ops.wkv6``; ``scan=ref.wkv6`` (the plain path
    the card run holds the kernel against) gives the same logits."""
    _, tcfg, _, tp = rwkv
    seen = []

    def spy(r, *rest):
        seen.append(r.shape[1])
        return ref.wkv6(r, *rest)
    monkeypatch.setattr(ops, "wkv6", spy)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 9)))
    logits, state = api.prefill(tp, {"tokens": toks}, tcfg)
    api.decode_step(tp, state, {"token": toks[:, 0],
                                "pos": torch.tensor([9, 9])}, tcfg)
    assert seen == [9] * tcfg.num_layers + [1] * tcfg.num_layers
    monkeypatch.undo()
    plain, _ = api.prefill(tp, {"tokens": toks}, tcfg, scan=ref.wkv6)
    torch.testing.assert_close(plain, logits, rtol=0, atol=0)


# -- (c) served tokens against the JAX group ---------------------------------


def test_served_tokens_match_jax(rwkv):
    """Two equal-length pairs, one per loop (round-robin), plus one odd
    length: three waves, B=2, 2 and 1, no mid-flight admission."""
    jcfg, tcfg, jp, tp = rwkv
    reqs = requests([11, 7, 11, 7, 5], [4, 3], seed=4)
    want, got, tg = served_tokens(jcfg, tcfg, jp, tp, reqs)
    assert got == want
    assert [len(t) for t in got] == [m for _, _, m in reqs]
    engines = [l.engine for l in tg.loops]
    assert sum(e.prefills for e in engines) == 3
    assert sum(e.admit_prefills for e in engines) == 0


# -- (d), (e) layout and sizes -----------------------------------------------


def test_batch_axes_and_param_count_match_jax(rwkv):
    jcfg, tcfg, _, tp = rwkv
    tc = api.init_cache(tcfg, 3, 16, device="cpu")
    jc = japi.init_cache(jcfg, 3, 16)
    assert cache_layout.batch_axes("ssm", tc) == jlayout.batch_axes("ssm", jc)
    assert_trees_close(tc, jc, dict(atol=0, rtol=0))
    full = api.init_cache(get_config("rwkv6-7b"), 1, 8, device="cpu")
    assert full["wkv"].dtype == torch.float32               # state in f32
    assert full["tm_x"].dtype == full["cm_x"].dtype == torch.bfloat16
    for arch in ("rwkv6-7b", ARCH):
        assert get_config(arch).param_count() == \
            jax_config(arch).param_count()
    assert get_config("rwkv6-7b").param_count() == 7_576_092_672
    assert sorted(p for p, _ in tree_paths(tp)) == sorted(
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(japi.init(
            jax.random.PRNGKey(0), jcfg))[0])


def test_family_trains(rwkv):
    """``api.loss`` trains the family through the plain scan (held
    against the reference in ``test_torch_train_families.py``): a finite
    loss and a zero aux."""
    _, tcfg, _, tp = rwkv
    toks = torch.zeros((1, 4), dtype=torch.long)
    loss, aux = api.loss(tp, {"tokens": toks, "labels": toks}, tcfg)
    assert torch.isfinite(loss) and float(aux["aux"]) == 0


def test_training_the_family_raises(rwkv):
    """Training through a stack mode that does not exist raises (the
    family itself trains: :func:`test_family_trains`)."""
    _, tcfg, _, tp = rwkv
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="unknown mode"):
        trwkv.apply_rwkv_stack(tp["layers"], x, tcfg, mode="training")


# -- (f) the casts and epsilons that make this the reference's model ---------


def test_layernorm_matches_jax_and_eps_matters(jax_ref):
    """Population variance and eps=1e-6 by default; a low-variance input
    tells 1e-6 from PyTorch's 1e-5."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 64)) * 3e-3 + 0.5).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(japply_norm(p, jnp.asarray(x), "layernorm"))
    close(apply_norm(tp, torch.from_numpy(x), "layernorm"), want, **TOL)
    swapped = apply_norm(tp, torch.from_numpy(x), "layernorm", eps=1e-5)
    assert np.abs(swapped.numpy() - want).max() > 100 * TOL["atol"]


@pytest.mark.parametrize("swap", [None, "ln_x_eps", "torch_ln_eps"])
def test_block_eps_swaps_are_caught(swap, rwkv, monkeypatch):
    """The parity check of one block has the power to see a swapped
    epsilon: ``ln_x`` at the default 1e-6 instead of 1e-5, or every layer
    norm at PyTorch's 1e-5. The inputs are scaled down so the variances
    are small, as they are at the start of a real sequence."""
    jcfg, tcfg, jp, tp = rwkv
    from repro.models import rwkv6 as jrwkv
    real = trwkv.apply_norm
    if swap == "ln_x_eps":
        monkeypatch.setattr(trwkv, "apply_norm",
                            lambda p, x, kind, eps=1e-6: real(p, x, kind))
    elif swap == "torch_ln_eps":
        monkeypatch.setattr(trwkv, "apply_norm",
                            lambda p, x, kind, eps=1e-6: real(p, x, kind,
                                                              eps=1e-5))
    x = (np.random.default_rng(6).standard_normal((2, 6, 64)) * 1e-2
         ).astype(np.float32)
    jst = jax.tree.map(lambda a: a[0], japi.init_cache(jcfg, 2, 8))
    jpl = jax.tree.map(lambda a: a[0], jp["layers"])
    want, _ = jrwkv.apply_rwkv_block(jpl, jnp.asarray(x), jcfg,
                                     shard_fn=lambda a, _: a, state=jst)
    tst = {k: v[0] for k, v in api.init_cache(tcfg, 2, 8,
                                              device="cpu").items()}
    tpl = tree_map(lambda a: a[0], tp["layers"])
    got, _ = trwkv.apply_rwkv_block(tpl, torch.from_numpy(x), tcfg,
                                    state=tst, scan=ref.wkv6)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    if swap is None:
        assert err <= TOL["atol"] + TOL["rtol"] * np.abs(want).max(), err
    else:
        assert err > 10 * TOL["atol"], err


# -- (g) the CUDA kernel on the card -----------------------------------------


# the chunked kernel's chunk boundaries and the decode kernel's threshold,
# each side (T <= DECODE_MAX_T runs the decode kernel)
CH, DMAX = _wk.CHUNK, _wk.DECODE_MAX_T
BOUNDARY_TS = sorted({1, 2, DMAX, DMAX + 1, CH - 1, CH, CH + 1, 2 * CH + 3})


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [16, 32, 64])
@pytest.mark.parametrize("t", sorted({5, 31, 32, 33, 100, *BOUNDARY_TS}))
def test_kernel_matches_plain_on_card(hs, t, cuda):
    """B*H = 6 (no multiple of 4), s0 != 0, ragged T and both sides of the
    chunk length and of the decode kernel's threshold, one launch per
    call."""
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(2, t, 3, hs, seed=hs + t)]
    before = ops.wkv6.launches
    y, sf = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert ops.wkv6.launches == before + 1
    ry, rsf = ref.wkv6(*args)
    close(y.cpu(), ry.cpu(), 2e-3, 2e-3)
    close(sf.cpu(), rsf.cpu(), 2e-3, 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("extreme", [False, True])
def test_kernel_at_the_model_shape_on_card(extreme, cuda):
    """rwkv6-7b's prefill shape, s0 != 0; extreme decays at 5e-3."""
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(2, 1024, 64, 64, seed=9, extreme=extreme)]
    y, sf = ops.wkv6(*args)
    torch.cuda.synchronize()
    ry, rsf = ref.wkv6(*args)
    tol = 5e-3 if extreme else 2e-3
    assert bool(torch.isfinite(y).all())
    close(y.cpu(), ry.cpu(), tol, tol)
    close(sf.cpu(), rsf.cpu(), tol, tol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_run(cuda):
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(1, 4, 2, 48, seed=3)]
    with pytest.raises(ValueError, match="hs"):
        ops.wkv6(*args)
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(1, 4, 2, 16, seed=3)]
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                 *args[1:])
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.wkv6(*args)


def chained(device, t, seed):
    """wkv6 over T, then over one more step from its final state: (y,
    s_final) over the T + 1 steps, and the numpy inputs of all of them."""
    args = scan_inputs(2, t + 1, 3, 64, seed=seed)
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(device) for a in args)
    part = lambda x, sl: x[:, sl].contiguous()
    y1, s1 = ops.wkv6(*(part(x, slice(0, t)) for x in (r, k, v, w)), u, s0)
    y2, s2 = ops.wkv6(*(part(x, slice(t, None)) for x in (r, k, v, w)), u,
                      s1)
    return (torch.cat([y1, y2], 1), s2), args


@pytest.mark.parametrize("t", [DMAX, CH, 2 * CH + 3])
def test_chained_scan_matches_one_call(t, jax_ref):
    """The plain path (CPU tensors), resumed from its final state for one
    step, against the JAX oracle over all T + 1 steps in one call."""
    (y, s), args = chained("cpu", t, seed=t)
    jy, jsf = jref.wkv6(*(jnp.asarray(a) for a in args))
    close(y, jy, 2e-3, 2e-3)
    close(s, jsf, 2e-3, 2e-3)


@pytest.mark.cuda
def test_kernel_constants_match_launcher(cuda):
    assert _wk.kernel_constants() == (_wk.CHUNK, _wk.DECODE_MAX_T)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [DMAX, CH, 2 * CH + 3])
def test_kernel_chained_scan_matches_one_call_on_card(t, cuda):
    """T steps, then T = 1 from their final state (the decode kernel),
    against T + 1 steps in one call."""
    (y, s), args = chained(cuda, t, seed=t)
    yw, sw = ops.wkv6(*(torch.from_numpy(a).to(cuda) for a in args))
    torch.cuda.synchronize()
    close(y.cpu(), yw.cpu(), 2e-3, 2e-3)
    close(s.cpu(), sw.cpu(), 2e-3, 2e-3)


@pytest.mark.cuda
def test_kernel_extreme_decays_at_the_decode_shape_on_card(cuda):
    """rwkv6-7b's decode step (B=2, T=1, H=64, hs=64) with half the
    channels decaying at 1e-6 and half at 1 - 1e-6, s0 != 0, at 5e-3."""
    r, k, v, w, u, s0 = scan_inputs(2, 1, 64, 64, seed=21)
    w = np.where(np.arange(64) % 2 == 0, 1e-6, 1 - 1e-6).astype(
        np.float32) * np.ones_like(w)
    args = [torch.from_numpy(a).to(cuda) for a in (r, k, v, w, u, s0)]
    y, sf = ops.wkv6(*args)
    torch.cuda.synchronize()
    ry, rsf = ref.wkv6(*args)
    close(y.cpu(), ry.cpu(), 5e-3, 5e-3)
    close(sf.cpu(), rsf.cpu(), 5e-3, 5e-3)


@pytest.mark.cuda
def test_kernel_rejects_a_misaligned_base_on_card(cuda):
    """The tensor maps need 16-byte-aligned bases: a contiguous view 4
    bytes past one is refused, never sent to the plain version."""
    args = [torch.from_numpy(a).to(cuda)
            for a in scan_inputs(1, 8, 2, 16, seed=4)]
    buf = torch.empty(args[0].numel() + 1, device=cuda)
    r_off = buf[1:].view_as(args[0])
    r_off.copy_(args[0])
    with pytest.raises(ValueError, match="aligned"):
        ops.wkv6(r_off, *args[1:])
