"""repro_torch's fault-tolerant trainer against the JAX reference, on the
CPU: gradient accumulation, fault injection and restart, the watchdog,
binary token shards, the CLI, and elastic restores on gloo rings.

* ``_microbatches`` equals the reference's split; three TAC steps of
  ``hadronio/bf16/pallas`` at ``microbatches=2`` equal the reference's
  at ``test_torch_train.py::test_three_tac_steps_match_jax``'s
  tolerances (see that module for why they are what they are), and the
  gspmd step at ``microbatches=2`` equals the reference's at the same
  tolerances for loss and params (no wire rounding: moments at rtol
  1e-4).
* ``train_with_restarts`` with ``REPRO_FAULT_AT_STEP``: one restart, the
  state restored from the step-2 checkpoint bitwise equal to the state
  saved there, the final loss within 1e-5 of an uninterrupted run (the
  bound of ``tests/distributed/check_train_ft.py``); on the CPU the
  final params are bitwise equal too.
* ``BinarySource`` batches (uint16, and uint32 named by ``.meta``)
  bitwise equal to ``repro.data``'s.
* gloo rings as subprocesses (FileStore in tmp_path, localhost only):
  ``hadronio_rs`` trained and saved on 2 peers, restored through
  ``restore_elastic`` on 4 and trained a step, then restored on 2
  again. Each peer's saved row is its live row (the gather), each
  restored flat moment shard equals the reference's
  ``reshard_flat_shards`` row bitwise, and the error feedback restarts
  from zero.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointStore, leaf_files
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.channels import Ring
from repro_torch.data import pipeline as tdata
from repro_torch.launch import elastic, steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import Trainer, Watchdog, train_with_restarts
from repro_torch.models.common import tree_paths
from repro_torch.models.convert import from_numpy_train_state

try:
    import jax
    import jax.numpy as jnp
    from repro import compat as jcompat
    from repro.configs.base import CommConfig as JCommConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.core.backends import get_backend as jax_backend
    from repro.data import pipeline as jdata
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
except ImportError:
    jax = None

ARCH = "qwen2-0.5b-reduced"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 24
COMM = dict(mode="hadronio", compress="bf16", pack="pallas",
            slice_bytes=64 * 1024, channels=4)


@pytest.fixture(scope="module")
def jx():
    if jax is None:
        pytest.skip("the JAX reference is not installed")


@pytest.fixture()
def ring():
    """A one-peer gloo ring in this process (no port: HashStore)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield Ring(channels=4)
    dist.destroy_process_group()


def _batch(step, vocab):
    return jdata.batch_at(jdata.SyntheticSource(vocab, 0),
                          jdata.DataConfig(S, B), step)


def _tbatch(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# -- gradient accumulation ---------------------------------------------------


def test_microbatches_match_jax(jx):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 99, (6, 5)).astype(np.int32),
             "labels": rng.integers(0, 99, (6, 5)).astype(np.int32)}
    for n in (1, 2, 3, 6):
        want = jsteps._microbatches(batch, n)
        got = steps._microbatches({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, n)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="does not split into 4"):
        steps._microbatches({"tokens": torch.zeros(6, 5)}, 4)


def _jax_steps(jrun, mesh_fn, batches):
    mesh = make_mesh((1,), ("data",))
    with jcompat.set_mesh(mesh):
        step_fn, _, _ = jsteps.make_train_step(jrun, mesh)
        state = mesh_fn(jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, state)
        f = jax.jit(step_fn)
        losses = []
        for b in batches:
            state, m = f(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    return start, jax.tree.map(np.asarray, state), losses


def test_three_tac_steps_with_microbatches_match_jax(jx, ring):
    """hadronio / bf16 / pallas at ``microbatches=2``: the exchange sees
    the f32 mean of two microbatches' gradients."""
    jrun = JRunConfig(model=jax_config(ARCH),
                      shape=JShapeConfig("t", "train", S, B),
                      comm=JCommConfig(hierarchical=False, **COMM),
                      warmup_steps=1, total_steps=3, microbatches=2)
    trun = RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", S, B),
                     comm=CommConfig(**COMM), warmup_steps=1, total_steps=3,
                     microbatches=2)
    batches = [_batch(k, jrun.model.vocab_size) for k in range(3)]
    start, jend, jlosses = _jax_steps(
        jrun, lambda k: jsteps.init_tac_state(k, jrun, 1), batches)
    state = from_numpy_train_state(start, "cpu")
    step_fn = steps.make_train_step(trun, ring)
    losses = []
    for b in batches:
        state, m = step_fn(state, _tbatch(b))
        losses.append(float(m["loss"]))

    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    want = from_numpy_train_state(jend, "cpu")
    assert state.step == 3 and state.opt.count == 3
    for (path, got), (_, ref) in zip(tree_paths(state.params),
                                     tree_paths(want.params)):
        _close(got, ref.numpy(), atol=1e-5, rtol=1e-4, err_msg=path)
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


def test_gspmd_step_with_microbatches_matches_jax(jx, ring):
    jrun = JRunConfig(model=jax_config(ARCH),
                      shape=JShapeConfig("t", "train", S, B),
                      comm=JCommConfig(mode="gspmd"), warmup_steps=1,
                      total_steps=2, microbatches=2)
    trun = RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", S, B),
                     comm=CommConfig(mode="gspmd"), warmup_steps=1,
                     total_steps=2, microbatches=2)
    batches = [_batch(k, jrun.model.vocab_size) for k in range(2)]
    start, jend, jlosses = _jax_steps(
        jrun, lambda k: jsteps.init_train_state(k, jrun), batches)
    state = from_numpy_train_state(start, "cpu")
    assert state.ef is None
    step_fn = steps.make_train_step(trun, ring)
    losses = []
    for b in batches:
        state, m = step_fn(state, _tbatch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    want = from_numpy_train_state(jend, "cpu")
    for tree_t, tree_j, tol in (
            (state.params, want.params, dict(atol=1e-5, rtol=1e-4)),
            (state.opt.mu, want.opt.mu, dict(atol=1e-7, rtol=1e-4)),
            (state.opt.nu, want.opt.nu, dict(atol=1e-10, rtol=1e-4))):
        for (path, got), (_, ref) in zip(tree_paths(tree_t),
                                         tree_paths(tree_j)):
            _close(got, ref.numpy(), err_msg=path, **tol)


def test_accumulated_grads_are_f32_and_one_microbatch_keeps_dtype():
    cfg = dataclasses.replace(get_config(ARCH), param_dtype="bfloat16")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 8, 4))
    params = steps.api.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    b = _tbatch(tdata.batch_at(tdata.SyntheticSource(cfg.vocab_size, 0),
                               tdata.DataConfig(8, 4), 0))
    _, g1 = steps._accumulate_grads(params, b, run, 1)
    _, g2 = steps._accumulate_grads(
        params, b, dataclasses.replace(run, microbatches=2), 1)
    assert {t.dtype for _, t in tree_paths(g1)} == {torch.bfloat16}
    assert {t.dtype for _, t in tree_paths(g2)} == {torch.float32}


# -- fault injection, restart, checkpoints -----------------------------------


def _ft_run(ckpt="", steps_=4, **kw):
    return RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", 16, B),
                     comm=CommConfig(**COMM), warmup_steps=1,
                     total_steps=steps_, microbatches=2,
                     checkpoint_dir=ckpt, checkpoint_every=2,
                     keep_checkpoints=2, async_checkpoint=True, **kw)


def test_fault_injection_restarts_from_last_checkpoint(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_AT_STEP", "3")
    monkeypatch.setenv("REPRO_FAULT_FLAG", str(tmp_path / "fault_fired"))
    run = _ft_run(str(tmp_path / "ck"))
    saved, restored, made, lines = {}, [], [], []

    class Probe(Trainer):
        """Keeps a copy of each state it saves and each it restores."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
            save = self.store.save_async

            def spy(step, state, extra=None):
                saved.setdefault(step, [
                    (n, x.clone() if torch.is_tensor(x) else x)
                    for n, x in leaf_files(state)])
                save(step, state, extra)
            self.store.save_async = spy

        def restore_or_init(self):
            state = super().restore_or_init()
            restored.append(leaf_files(state))
            return state

    out = train_with_restarts(
        lambda: Probe(run, device="cpu", log_fn=lines.append),
        log_fn=lines.append)
    assert out["restarts"] == 1 and len(made) == 2
    assert not dist.is_initialized()      # each Trainer closed its group
    assert sum("[supervisor] step failed" in x for x in lines) == 1
    assert "[trainer] restoring step 2" in lines
    assert (tmp_path / "fault_fired").read_text() == "3"
    assert restored[0][-1][0] == ".ef.npy" and sorted(saved) == [2, 4]
    # what the restart restored is what was saved at step 2, bitwise
    for (name, got), (_, want) in zip(restored[1], saved[2]):
        if torch.is_tensor(want):
            assert got.dtype == want.dtype and torch.equal(got, want), name
        else:
            assert got == want, name
    assert any(torch.is_tensor(x) and x.abs().max() > 0
               for n, x in saved[2] if n == ".ef.npy")
    store = CheckpointStore(run.checkpoint_dir)
    assert store.available_steps() == [2, 4] and store.latest_step() == 4
    assert store.manifest(4)["extra"] == {"loss": out["final_loss"],
                                          "arch": ARCH}

    clean = Trainer(_ft_run(), device="cpu", log_fn=lines.append)
    try:
        want = clean.run_loop()
    finally:
        clean.close()
    assert abs(out["final_loss"] - want["final_loss"]) < 1e-5
    for (path, a), (_, b) in zip(tree_paths(out["state"].params),
                                 tree_paths(want["state"].params)):
        assert torch.equal(a, b), path


def test_failure_past_the_limit_raises_and_closes(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_AT_STEP", "1")
    monkeypatch.setenv("REPRO_FAULT_FLAG", str(tmp_path / "fault_fired"))
    with pytest.raises(RuntimeError, match="injected fault at step 1"):
        train_with_restarts(lambda: Trainer(_ft_run(), device="cpu",
                                            log_fn=lambda s: None),
                            max_restarts=0, log_fn=lambda s: None)
    assert not dist.is_initialized()


def test_watchdog_fires_and_disarms():
    fired = threading.Event()
    wd = Watchdog(0.05, fired.set)
    wd.arm()
    assert fired.wait(5.0)
    late = threading.Event()
    wd = Watchdog(0.2, late.set)
    wd.arm()
    wd.disarm()
    time.sleep(0.4)
    assert not late.is_set()


# -- data and the CLI --------------------------------------------------------


def _write_shards(path, dtype, sizes, vocab, meta):
    rng = np.random.default_rng(7)
    os.makedirs(path, exist_ok=True)
    for i, n in enumerate(sizes):
        rng.integers(0, vocab, n).astype(dtype).tofile(
            os.path.join(path, f"shard_{i}.bin"))
        if meta:
            with open(os.path.join(path, f"shard_{i}.meta"), "w") as f:
                f.write(np.dtype(dtype).name)


@pytest.mark.parametrize("dtype,meta", [(np.uint16, False),
                                        (np.uint16, True),
                                        (np.uint32, True)])
def test_binary_source_matches_jax(jx, tmp_path, dtype, meta):
    _write_shards(tmp_path, dtype, (1000, 37, 2048), 70000 if
                  dtype == np.uint32 else 60000, meta)
    for seed, step, hosts in ((0, 0, 1), (3, 5, 2)):
        dc = dict(seq_len=64, global_batch=4, host_index=hosts - 1,
                  num_hosts=hosts)
        want = jdata.batch_at(jdata.BinarySource(str(tmp_path), seed),
                              jdata.DataConfig(**dc), step)
        got = tdata.batch_at(tdata.BinarySource(str(tmp_path), seed),
                             tdata.DataConfig(**dc), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_cli_checkpoints_data_microbatches(tmp_path, capsys):
    _write_shards(tmp_path / "data", np.uint16, (5000,), 256, True)
    args = ["--arch", ARCH, "--device", "cpu", "--global-batch", "4",
            "--seq-len", "16", "--compress", "bf16", "--pack", "pallas",
            "--microbatches", "2", "--ckpt", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--data", str(tmp_path / "data")]
    assert train_cli.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[trainer] step 2 loss" in out and "final loss:" in out
    store = CheckpointStore(str(tmp_path / "ck"))
    assert store.available_steps() == [2, 3]
    assert train_cli.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[trainer] restoring step 3" in out
    assert "[trainer] step 3 loss" in out and "step 0 loss" not in out
    assert store.available_steps() == [2, 3, 4]


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", ARCH, "--steps", "1", "--ckpt",
                        str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_ft_run(str(tmp_path)))


# -- elastic restores on gloo rings (subprocesses) ---------------------------

_WORKER = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channels import Ring
    from repro_torch.launch import elastic, steps
    from repro_torch.launch.train import Trainer

    rank, world, store, ck, total, out = (int(sys.argv[1]),
                                          int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], int(sys.argv[5]),
                                          sys.argv[6])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        run = RunConfig(model=get_config("qwen2-0.5b-reduced"),
                        shape=ShapeConfig("t", "train", 16, 4),
                        comm=CommConfig(mode="hadronio_rs", compress="bf16",
                                        slice_bytes=64 * 1024, channels=2),
                        warmup_steps=1, total_steps=total,
                        checkpoint_dir=ck, checkpoint_every=100)
        rows = lambda s: {"mu": s.opt.mu.numpy(), "nu": s.opt.nu.numpy(),
                          "ef": s.ef.numpy(), "step": s.step,
                          "count": s.opt.count, "params": {
                              p: t.numpy() for p, t in
                              steps.tree_paths(s.params)}}
        res = {}
        store = CheckpointStore(ck, group=dist.group.WORLD,
                                rows=steps.ring_rows)
        state = None
        if store.latest_step() is not None:
            state, s = elastic.restore_elastic(store, run, Ring(channels=2),
                                               device="cpu")
            res["restored"] = rows(state)
        trainer = Trainer(run, device="cpu", log_fn=lambda line: None)
        try:
            o = trainer.run_loop(state)
        finally:
            trainer.close()
        res["final"] = rows(o["state"])
        res["losses"] = o["losses"]
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')


def _ring_phase(tmp_path, world, ck, total, tag):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / f"store_{tag}"), ck, str(total),
         str(tmp_path / f"{tag}_{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = []
    for r in range(world):
        with open(tmp_path / f"{tag}_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def test_elastic_restore_on_gloo_rings(jx, tmp_path):
    """2 peers train 2 steps and save; 4 peers restore (2 -> 4), train a
    step and save; 2 peers restore again (4 -> 2) and train a step."""
    ck = str(tmp_path / "ck")
    jrun = JRunConfig(model=jax_config(ARCH),
                      shape=JShapeConfig("t", "train", 16, 4),
                      comm=JCommConfig(mode="hadronio_rs", compress="bf16",
                                       slice_bytes=64 * 1024,
                                       hierarchical=False))
    backend = jax_backend("hadronio_rs")
    saved = lambda step, name: np.load(os.path.join(
        ck, f"step_{step:08d}", name))
    prev = _ring_phase(tmp_path, 2, ck, 2, "a")
    for phase, (world, total) in enumerate(((4, 3), (2, 4))):
        step = total - 1
        # what was saved is every peer's live row, stacked in ring order
        for name, key in ((".opt_.mu.npy", "mu"), (".opt_.nu.npy", "nu"),
                          (".ef.npy", "ef")):
            np.testing.assert_array_equal(
                saved(step, name), np.stack([o["final"][key]
                                             for o in prev]))
        outs = _ring_phase(tmp_path, world, ck, total, "bc"[phase])
        for key, name in (("mu", ".opt_.mu.npy"), ("nu", ".opt_.nu.npy")):
            want = backend.reshard_flat_shards(jrun, saved(step, name),
                                               world)
            assert want.shape[0] == world and np.abs(want).max() > 0
            for r, o in enumerate(outs):
                np.testing.assert_array_equal(o["restored"][key], want[r])
        for o in outs:
            got = o["restored"]
            assert not got["ef"].any() and got["ef"].shape == \
                prev[0]["final"]["ef"].shape
            assert got["step"] == step and got["count"] == step
            for p, t in prev[0]["final"]["params"].items():
                np.testing.assert_array_equal(got["params"][p], t)
            assert len(o["losses"]) == 1 and np.isfinite(o["losses"][0])
        prev = outs
