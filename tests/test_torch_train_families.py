"""Training every model family of repro_torch against the JAX reference
on the CPU, each at its ``-reduced`` config (f32): mixtral-8x7b and
dbrx-132b (moe), rwkv6-7b (ssm), recurrentgemma-9b (hybrid), whisper-tiny
(encdec) and llava-next-mistral-7b (vlm).

* ``api.loss``, its aux dict (keys and values) and every leaf's gradient
  against ``jax.value_and_grad(repro.models.api.loss)``, on the same
  params (the JAX init plus seeded numpy noise, carried across by
  ``models/convert``) and the same batch (tokens, labels and the stub
  frontends' frames or patches, drawn from one numpy seed, as
  ``tests/test_arch_smoke.py`` makes them). Tolerances are
  ``test_torch_train.py``'s: the loss at atol = rtol = 1e-4, gradients
  at atol 1e-5, rtol 1e-4 (the frameworks sum in other orders;
  recurrentgemma's ``lax.associative_scan`` sums in another order than
  the port's step loop too, and stays inside the same bounds);
* one AdamW step over the family's tree against
  ``repro.optim.adamw.update``, both fed the reference's gradients (an
  element whose gradient is near Adam's eps takes a step that follows
  the frameworks' f32 noise, so each framework's own gradients would
  not make a fair input): the clipped norm at the loss's tolerance,
  params at atol 1e-5 (a missed or sign-flipped update of any element
  fails: a step of lr is 1e-3), moments at the gradients' tolerance;
* train mode reaches no kernel wrapper, not even its plain version on
  the CPU: ``ops.flash_attention``, ``ops.wkv6`` and ``ops.rglru`` are
  made to fail, and every family still trains (the kernels have no
  backward, so on a card the wrappers would raise);
* for moe, ssm and hybrid, three TAC steps of the port's ``Trainer``
  under ``hadronio``/bf16/``pallas`` against the reference's
  ``Trainer`` from the same start state on the same batches, at
  ``test_torch_train.py``'s bounds for the same comparison, with one
  exception it does not meet: an element whose root-mean-square
  gradient (the reference's bias-corrected second moment) is nonzero
  and below 10x Adam's eps of 1e-8 takes steps of ``m / (sqrt(v) + eps)`` that
  follow the f32 noise of a gradient ~1e-9 (mixtral's embedding row of
  a token seen once: its first moment differs by 20% between the
  frameworks). Such elements are held to three steps of the learning
  rate (the most three Adam steps move an element), and at most 0.1% of
  a leaf may miss atol 1e-5; every other element is held to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, close, model_pair

from repro import compat as jcompat
from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import get_config as jax_config
from repro.launch.mesh import make_mesh
from repro.launch.train import Trainer as JTrainer
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import Trainer
from repro_torch.models import api, attention
from repro_torch.models.common import tree_from_paths, tree_paths
from repro_torch.models.convert import (from_numpy_params,
                                        from_numpy_train_state)
from repro_torch.optim import adamw

ARCHS = ("mixtral-8x7b", "dbrx-132b", "rwkv6-7b", "recurrentgemma-9b",
         "whisper-tiny", "llava-next-mistral-7b")
B, S = 2, 16
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _batch(cfg, seed: int = 0) -> dict:
    """Tokens and labels, plus frames (encdec) or patches (vlm) of
    N(0, 1), from one numpy seed."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    extra = {"encdec": ("frames", cfg.num_frames),
             "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if extra:
        name, n = extra
        out[name] = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    return out


def _tbatch(b: dict) -> dict:
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in b.items()}


def _jpaths(tree) -> dict:
    return {".".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_loss_grads(tp, batch, cfg):
    leaves = {p: t.detach().clone().requires_grad_(True)
              for p, t in tree_paths(tp)}
    loss, aux = api.loss(tree_from_paths(leaves.items()), _tbatch(batch),
                         cfg)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        tree_from_paths((p, t.grad) for p, t in leaves.items())


@pytest.fixture(scope="module", params=ARCHS)
def trained(request):
    """Both frameworks' loss, aux and gradients on one pair of params."""
    jcfg, tcfg, jp, tp = model_pair(request.param + "-reduced", seed=3)
    b = _batch(tcfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True),
                             static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    tl, taux, tg = _port_loss_grads(tp, b, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jl=jl, jaux=jaux, jg=jg,
                tl=tl, taux=taux, tg=tg)


def test_loss_aux_and_grads_match_jax(trained):
    t = trained
    close(t["tl"], t["jl"], **TOL)
    assert sorted(t["taux"]) == sorted(t["jaux"])
    assert sorted(t["taux"]) == (["xent"] if t["tcfg"].family == "encdec"
                                 else ["aux", "xent"])
    for k in t["jaux"]:
        close(t["taux"][k], t["jaux"][k], **TOL)
    if t["tcfg"].family == "moe":
        assert float(t["taux"]["aux"]) > 0      # balance + z-loss
    jg = _jpaths(t["jg"])
    tg = dict(tree_paths(t["tg"]))
    assert sorted(tg) == sorted(jg)
    for path, g in tg.items():
        assert g is not None, path
        close(g, jg[path], **GRAD_TOL)


def test_adamw_step_matches_jax(trained):
    t = trained
    shape = dict(name="t", kind="train", seq_len=S, global_batch=B)
    jrun = JRunConfig(model=t["jcfg"], shape=JShapeConfig(**shape),
                      lr=1e-3, warmup_steps=1, total_steps=2)
    trun = RunConfig(model=t["tcfg"], shape=ShapeConfig(**shape), lr=1e-3,
                     warmup_steps=1, total_steps=2)
    jnew, jopt, jm = jax.jit(lambda g, p: jadamw.update(
        g, jadamw.init(p), p, jrun))(t["jg"], t["jp"])
    grads = from_numpy_params(jax.tree.map(np.asarray, t["jg"]), "cpu")
    tnew, topt, tm = adamw.update(grads, adamw.init(t["tp"]), t["tp"],
                                  trun)
    close(tm["grad_norm"], jm["grad_norm"], **TOL)
    assert topt.count == 1
    moved = 0.0
    for tree_t, tree_j, tol in ((tnew, jnew, dict(atol=1e-5, rtol=0)),
                                (topt.mu, jopt.mu, GRAD_TOL),
                                (topt.nu, jopt.nu, GRAD_TOL)):
        jl = _jpaths(tree_j)
        for path, leaf in tree_paths(tree_t):
            close(leaf, jl[path], **tol)
    for (_, a), (_, b) in zip(tree_paths(tnew), tree_paths(t["tp"])):
        moved = max(moved, float((a - b).abs().max()))
    assert moved > 5e-4, moved     # every param moved by ~lr at most


def test_adamw_in_place_and_chunked_is_bitwise(trained, monkeypatch):
    """``adamw.update(..., inplace=True)``, a donated state's update,
    writes into the tensors it was given and equals the functional
    update bit for bit, also when each leaf is cut into chunks of 997
    elements (a prime: a leaf past it ends in a ragged chunk)."""
    t = trained
    run = RunConfig(model=t["tcfg"], shape=ShapeConfig("t", "train", S, B),
                    lr=1e-3, grad_clip=0.1, warmup_steps=1, total_steps=4)
    clone = lambda tree: tree_from_paths((p, x.clone())
                                         for p, x in tree_paths(tree))
    opt = adamw.init(t["tp"])
    opt = opt._replace(mu=clone(t["tg"]), nu=tree_from_paths(
        (p, x.square()) for p, x in tree_paths(t["tg"])), count=2)
    want, wopt, wm = adamw.update(t["tg"], opt, t["tp"], run)
    monkeypatch.setattr(adamw, "CHUNK", 997)
    params, given = clone(t["tp"]), opt._replace(mu=clone(opt.mu),
                                                 nu=clone(opt.nu))
    got, gopt, gm = adamw.update(t["tg"], given, params, run, inplace=True)
    assert torch.equal(gm["grad_norm"], wm["grad_norm"]) and \
        gm["lr"] == wm["lr"] and gopt.count == wopt.count == 3
    assert float(wm["grad_norm"]) > run.grad_clip        # clipping is on
    for tree_g, tree_w, tree_in in ((got, want, params),
                                    (gopt.mu, wopt.mu, given.mu),
                                    (gopt.nu, wopt.nu, given.nu)):
        for (path, g), (_, w), (_, x) in zip(tree_paths(tree_g),
                                             tree_paths(tree_w),
                                             tree_paths(tree_in)):
            assert g is x, path
            assert torch.equal(g, w), path
    assert all(not torch.equal(w, x) for (_, w), (_, x) in zip(
        tree_paths(want), tree_paths(t["tp"])))       # every leaf moved


@pytest.mark.parametrize("mode", ("hadronio", "sockets", "gspmd"))
def test_donated_steps_match_and_reuse_state(mode):
    """Two steps of mixtral-8x7b-reduced from one start state, built
    with and without ``donate``: the same losses, params, moments and EF
    bit for bit, and the donated run's params and moments are the start
    state's own tensors (one copy of them lives)."""
    comm = dict(mode=mode, slice_bytes=64 * 1024, channels=2)
    if mode == "hadronio":
        comm.update(compress="bf16", pack="pallas")
    run = RunConfig(model=get_config("mixtral-8x7b-reduced"),
                    shape=ShapeConfig("t", "train", S, B),
                    comm=CommConfig(**comm), warmup_steps=1, total_steps=2)
    clone = lambda tree: tree_from_paths((p, x.clone())
                                         for p, x in tree_paths(tree))
    out = {}
    for donate in (False, True):
        trainer = Trainer(run, device="cpu", log_fn=lambda line: None,
                          donate=donate)
        try:
            start = trainer.init_state()
            ptrs = [x.data_ptr() for tree in (start.params, start.opt.mu)
                    for _, x in tree_paths(tree)]
            keep = (clone(start.params), clone(start.opt.mu))
            o = trainer.run_loop(start)
        finally:
            trainer.close()
        end = o["state"]
        after = [x.data_ptr() for tree in (end.params, end.opt.mu)
                 for _, x in tree_paths(tree)]
        assert (after == ptrs) == donate, mode
        if not donate:      # the caller's state is as it was
            for tree, kept in zip((start.params, start.opt.mu), keep):
                for (p, x), (_, k) in zip(tree_paths(tree),
                                          tree_paths(kept)):
                    assert torch.equal(x, k), p
        out[donate] = o
    a, b = out[False], out[True]
    assert a["losses"] == b["losses"] and all(np.isfinite(a["losses"]))
    sa, sb = a["state"], b["state"]
    for tree_a, tree_b in ((sa.params, sb.params), (sa.opt.mu, sb.opt.mu),
                           (sa.opt.nu, sb.opt.nu)):
        for (p, x), (_, y) in zip(tree_paths(tree_a), tree_paths(tree_b)):
            assert torch.equal(x, y), p
    assert (sa.ef is None) == (mode != "hadronio")
    if sa.ef is not None:
        assert torch.equal(sa.ef, sb.ef)


def test_train_or_kernel_picks_by_mode():
    """Every model stack picks its attention and scans through
    ``ops.train_or_kernel``: the caller's function when given, the
    plain one in train mode, the kernel wrapper otherwise; an unknown
    mode raises."""
    plain, kernel, given = (lambda: 0), (lambda: 1), (lambda: 2)
    assert ops.train_or_kernel("train", None, plain, kernel) is plain
    for mode in ("prefill", "decode"):
        assert ops.train_or_kernel(mode, None, plain, kernel) is kernel
    for mode in ops.MODES:
        assert ops.train_or_kernel(mode, given, plain, kernel) is given
    with pytest.raises(ValueError, match="unknown mode"):
        ops.train_or_kernel("training", None, plain, kernel)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_mode_launches_no_kernel(arch, monkeypatch):
    """The kernel wrappers fail if called, so train mode may not reach
    them even on the CPU, where they would quietly run their plain
    versions; the plain attention and scans run instead, and their
    parameters get gradients."""
    for name in ("flash_attention", "wkv6", "rglru"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k: pytest.fail(
            f"ops.{_n} reached in train mode"))
    calls = {"attend_chunked": 0, "wkv6": 0, "rglru": 0}

    def counted(mod, name, key):
        real = getattr(mod, name)

        def wrapper(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    counted(attention, "attend_chunked", "attend_chunked")
    counted(ref, "wkv6", "wkv6")
    counted(ref, "rglru", "rglru")
    cfg = get_config(arch + "-reduced")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    loss, _, grads = _port_loss_grads(params, _batch(cfg, seed=1), cfg)
    assert torch.isfinite(loss)
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.num_layers)] if cfg.family == "hybrid" \
        else []
    n_attn = {"ssm": 0, "hybrid": kinds.count("local_attn"),
              "encdec": cfg.encoder_layers + cfg.num_layers}.get(
        cfg.family, cfg.num_layers)
    n_rglru = kinds.count("rglru")
    # a recomputed layer runs its forward twice: once under the
    # checkpoint, once in the backward
    remat = 2 if cfg.family in ("ssm", "hybrid") else 1
    assert calls == {"attend_chunked": remat * n_attn,
                     "wkv6": remat * cfg.num_layers * (cfg.family == "ssm"),
                     "rglru": remat * n_rglru}, calls
    g = dict(tree_paths(grads))
    trained_leaf = {"moe": "layers.attn.wq", "vlm": "layers.attn.wq",
                    "ssm": "layers.tm.u", "hybrid": "layers.groups.b0_rglru.lam",
                    "encdec": "enc0.attn.wq"}[cfg.family]
    assert bool(g[trained_leaf].abs().sum() > 0), trained_leaf


def _jax_trainer(jrun, n_steps):
    mesh = make_mesh((1,), ("data",))
    t = JTrainer(jrun, mesh, log_fn=lambda line: None)
    with jcompat.set_mesh(mesh):
        start = jax.tree.map(np.asarray, t.init_state())
    out = t.run_loop()
    return start, jax.tree.map(np.asarray, out["state"]), out["losses"]


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "rwkv6-7b",
                                  "recurrentgemma-9b"))
def test_three_tac_steps_match_jax_trainer(arch):
    """hadronio / bf16 / pallas (the ring-pack kernels' path; their plain
    versions on these CPU tensors): the port's ``Trainer.run_loop`` from
    the reference ``Trainer``'s start state, on the same synthetic
    batches, against that ``Trainer``'s own three steps (its Pallas
    kernels in interpret mode). Bounds as in
    ``test_torch_train.test_three_tac_steps_match_jax``, which explains
    them."""
    comm = dict(mode="hadronio", compress="bf16", pack="pallas",
                slice_bytes=64 * 1024, channels=4)
    shape = dict(name="t", kind="train", seq_len=S, global_batch=B)
    jrun = JRunConfig(model=jax_config(arch + "-reduced"),
                      shape=JShapeConfig(**shape),
                      comm=JCommConfig(hierarchical=False, **comm),
                      warmup_steps=1, total_steps=3)
    trun = RunConfig(model=get_config(arch + "-reduced"),
                     shape=ShapeConfig(**shape), comm=CommConfig(**comm),
                     warmup_steps=1, total_steps=3)
    start, jend, jlosses = _jax_trainer(jrun, 3)

    trainer = Trainer(trun, device="cpu", log_fn=lambda line: None,
                      donate=True)      # as the reference's Trainer
    try:
        out = trainer.run_loop(from_numpy_train_state(start, "cpu"))
    finally:
        trainer.close()
    state = out["state"]
    assert all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], jlosses, **TOL)
    assert state.step == 3 and state.opt.count == 3
    want = from_numpy_train_state(jend, "cpu")
    c2 = 1.0 - trun.beta2 ** 3
    for (path, got), (_, w), (_, nu) in zip(tree_paths(state.params),
                                            tree_paths(want.params),
                                            tree_paths(want.opt.nu)):
        rms = (nu / c2).sqrt()         # zero where no gradient reached
        noise = (rms > 0) & (rms < 10 * trun.eps)
        close(got[~noise], w[~noise], atol=1e-5, rtol=1e-4)
        close(got[noise], w[noise], atol=3 * trun.lr, rtol=0)
        off = (got - w).abs() > 1e-5 + 1e-4 * w.abs()
        assert float(off.float().mean()) <= 1e-3, path
    for tree_t, tree_j in ((state.opt.mu, want.opt.mu),
                           (state.opt.nu, want.opt.nu)):
        for (path, got), (_, w) in zip(tree_paths(tree_t),
                                       tree_paths(tree_j)):
            scale = float(w.abs().max())
            assert scale > 0, path
            close(got, w, atol=1e-3 * scale, rtol=2 ** -7)
    ef_scale = float(want.ef.abs().max())
    assert ef_scale > 0
    diff = (state.ef - want.ef).abs()
    assert float((diff > 1e-3 * ef_scale).float().mean()) < 0.01
    assert float(diff.max()) <= 4 * ef_scale
