"""repro_torch training slice against the JAX reference on
qwen2-0.5b-reduced (f32): the loss and its gradients, the data
pipeline, and three TAC steps of ``hadronio`` with bf16 wire
compression through the ring-pack kernels' path (``pack="pallas"``),
started from the same state (the JAX state carried across by
``models.convert.from_numpy_train_state``) on the same batches.

Tolerances:
* loss and gradients: atol = rtol = 1e-4 (``test_torch_models.py``'s:
  the frameworks sum in other orders; nothing else differs).
* three TAC steps: the gradients differ in their last f32 bits, so a
  gradient lying within an f32 ulp of a bf16 rounding boundary may
  round to the neighbouring bf16 value on the wire in one framework and
  not the other (one bf16 ulp, 2^-8 relative), with the error-feedback
  residual taking up the difference. Every bound is tied to the scale of
  what it compares, so a zeroed or wrong tensor cannot pass under an
  absolute floor: EF agrees to 1e-3 of its largest residual on all but
  1% of its elements (the f32 noise is ~1e-9 against residuals of
  ~1e-5; rounding flips are rare), and everywhere to within 4x its
  largest residual (the largest residual is about half a bf16 ulp of
  the largest gradient, a flip moves one ulp); mu/nu per leaf at rtol
  2^-7 (two bf16 ulps) with an atol of 1e-3 of the leaf's largest
  magnitude; params at atol 1e-5, 30x below one Adam step of the
  learning rate (3e-4), so a missed or sign-flipped update of any
  element fails; the loss at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import compat as jcompat
from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import get_config as jax_config
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import api as japi
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.channels import Ring
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps, train as train_cli
from repro_torch.models import api, transformer
from repro_torch.models.common import tree_from_paths, tree_paths
from repro_torch.models.convert import (from_numpy_params,
                                        from_numpy_train_state)

ARCH = "qwen2-0.5b-reduced"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24


@pytest.fixture(scope="module")
def ring():
    """A one-peer gloo ring in this process (no port: HashStore)."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield Ring(channels=4)
    if own:
        dist.destroy_process_group()


def _batch(step: int, vocab: int, seed: int = 0):
    src = jdata.SyntheticSource(vocab, seed)
    return jdata.batch_at(src, jdata.DataConfig(S, B), step)


def _tbatch(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def test_batch_at_tokens_identical():
    for seed, step in [(0, 0), (0, 7), (3, 2)]:
        want = jdata.batch_at(jdata.SyntheticSource(256, seed),
                              jdata.DataConfig(32, 4, host_index=1,
                                               num_hosts=2), step)
        got = tdata.batch_at(tdata.SyntheticSource(256, seed),
                             tdata.DataConfig(32, 4, host_index=1,
                                              num_hosts=2), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_loss_and_grads_match_jax():
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    jp = japi.init(jax.random.PRNGKey(1), jcfg)
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    b = _batch(0, tcfg.vocab_size)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                             static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    leaves = {p: t.requires_grad_(True) for p, t in tree_paths(tp)}
    tl, taux = api.loss(tree_from_paths(leaves.items()), _tbatch(b), tcfg)
    tl.backward()
    _close(tl, jl)
    _close(taux["xent"], jaux["xent"])
    jgrads = dict((".".join(str(k.key) for k in path), g) for path, g in
                  jax.tree_util.tree_flatten_with_path(jg)[0])
    assert set(jgrads) == set(leaves)
    for path, t in leaves.items():
        _close(t.grad, jgrads[path], atol=1e-5, rtol=1e-4)


def test_train_mode_uses_plain_attention_and_trains_wq(monkeypatch):
    """Train mode routes through ``attend_chunked``, never through the
    kernel wrapper (not even to its plain version on the CPU), and the
    attention projections get nonzero gradients."""
    cfg = get_config(ARCH)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    calls = []
    real = transformer.att.attend_chunked
    monkeypatch.setattr(transformer.att, "attend_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(transformer.ops, "flash_attention",
                        lambda *a, **k: pytest.fail("kernel in train mode"))
    for t in params["layers"]["attn"].values():
        t.requires_grad_(True)
    loss, _ = api.loss(params, _tbatch(_batch(0, cfg.vocab_size)), cfg)
    loss.backward()
    assert len(calls) == cfg.num_layers
    for name in ("wq", "wk", "wv", "wo"):
        g = params["layers"]["attn"][name].grad
        assert g is not None and bool(g.abs().sum() > 0), name


def _jax_tac(jrun, n_steps, batches):
    mesh = make_mesh((1,), ("data",))
    with jcompat.set_mesh(mesh):
        step_fn, state_sh, _ = jsteps.make_train_step(jrun, mesh)
        state = jsteps.init_tac_state(jax.random.PRNGKey(0), jrun, 1)
        start = jax.tree.map(np.asarray, state)
        f = jax.jit(step_fn)
        losses = []
        for b in batches[:n_steps]:
            state, m = f(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    return start, jax.tree.map(np.asarray, state), losses


def test_three_tac_steps_match_jax(ring):
    """hadronio / bf16 / pallas (the ring-pack kernels' path; their
    plain versions on these CPU tensors) against the reference's TAC
    step on a one-device mesh (its Pallas kernels in interpret mode)."""
    jcfg = jax_config(ARCH)
    comm = dict(mode="hadronio", compress="bf16", pack="pallas",
                slice_bytes=64 * 1024, channels=4)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("t", "train", S, B),
                      comm=JCommConfig(hierarchical=False, **comm),
                      warmup_steps=1, total_steps=3)
    trun = RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", S, B),
                     comm=CommConfig(**comm), warmup_steps=1, total_steps=3)
    batches = [_batch(k, jcfg.vocab_size) for k in range(3)]
    start, jend, jlosses = _jax_tac(jrun, 3, batches)

    state = from_numpy_train_state(start, "cpu")
    assert state.ef is not None and state.ef.shape == start.ef.shape[1:]
    step_fn = steps.make_train_step(trun, ring)
    losses = []
    for b in batches:
        state, m = step_fn(state, _tbatch(b))
        losses.append(float(m["loss"]))

    np.testing.assert_allclose(losses, jlosses, **TOL)
    assert state.step == 3 and state.opt.count == 3
    want = from_numpy_train_state(jend, "cpu")
    for (path, got), (_, ref) in zip(tree_paths(state.params),
                                     tree_paths(want.params)):
        _close(got, ref.numpy(), atol=1e-5, rtol=1e-4)
    for tree_t, tree_j in ((state.opt.mu, want.opt.mu),
                           (state.opt.nu, want.opt.nu)):
        for (path, got), (_, ref) in zip(tree_paths(tree_t),
                                         tree_paths(tree_j)):
            scale = float(ref.abs().max())
            assert scale > 0, path
            _close(got, ref.numpy(), atol=1e-3 * scale, rtol=2 ** -7)
    ef_scale = float(want.ef.abs().max())
    assert ef_scale > 0
    diff = (state.ef - want.ef).abs()
    assert float((diff > 1e-3 * ef_scale).float().mean()) < 0.01
    assert float(diff.max()) <= 4 * ef_scale


# -- the CLI and the no-quiet-CPU rule ---------------------------------------


def test_cli_trains_on_cpu(capsys):
    rc = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                         "--global-batch", "2", "--seq-len", "16",
                         "--compress", "bf16", "--pack", "pallas"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[trainer] step 0 loss" in out and "[trainer] step 1 loss" in out
    assert "final loss:" in out


def test_gspmd_trains_one_peer(ring):
    """``gspmd`` (manual=False): local grads and a tree AdamW, the same
    update the hadronio step makes with an uncompressed wire at ring
    size 1 (the sum over one peer is the peer's own gradient)."""
    cfg = get_config(ARCH)
    out = {}
    for mode in ("gspmd", "hadronio"):
        run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", S, B),
                        comm=CommConfig(mode=mode), warmup_steps=1,
                        total_steps=2)
        state = steps.init_tac_state(torch.Generator().manual_seed(0), run,
                                     "cpu")
        assert state.ef is None
        step_fn = steps.make_train_step(run, ring)
        for k in range(2):
            state, m = step_fn(state, _tbatch(_batch(k, cfg.vocab_size)))
        out[mode] = state
    for (p, a), (_, b) in zip(tree_paths(out["gspmd"].params),
                              tree_paths(out["hadronio"].params)):
        assert torch.equal(a, b), p


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", ARCH, "--steps", "1"])
    run = RunConfig(model=get_config(ARCH),
                    shape=ShapeConfig("t", "train", S, B))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.Trainer(run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.init_tac_state(torch.Generator(), run)
