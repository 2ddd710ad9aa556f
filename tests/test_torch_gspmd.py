"""repro_torch's GSPMD train step on DTensor against the JAX reference's
``make_train_step_gspmd`` (``tests/distributed/check_steps.py``'s
production 2-D step: FSDP over ``data``, TP over ``model``, SP through
the activation constraints):

* MESHES — ``qwen1.5-4b-reduced`` (the config of ``check_steps.py``)
  trains 2 steps on gloo peers over ``(2, 1)``, ``(1, 2)``, ``(2, 2)``
  ``("data", "model")`` and ``(2, 2, 1)`` ``("pod", "data", "model")``
  meshes, from the reference's numpy init, on the same two global
  batches as the reference on 4 host devices with the same mesh shapes
  (a JAX subprocess, run beside them). The losses are held at the
  reference's own transparency tolerances (``check_steps.py``: 1e-4 at
  step 1, 1e-3 at step 2) and the final params at atol 1e-5 / rtol 1e-4
  (``test_torch_train.py``'s bounds for two TAC steps); every peer holds
  the same loss and the same full params. Every param and both moments
  stay DTensors at their ``param_shardings`` placements after each
  step, and each peer's local block has the shape of the reference's
  addressable shard. ``hlo_analysis.record()`` sees the step's
  collectives: all-gathers, reduce-scatters and all-reduces over one
  mesh dim's pair of peers. The ``(2, 2, 1)`` run goes through the
  ``Trainer`` (``--mesh 2x2x1``'s DeviceMesh).
* CHECKPOINTS — a state saved on ``(2, 1)`` restores bit for bit onto
  ``(1, 2)`` (every peer's block of every leaf) and onto one peer (the
  file is the global layout); a ``Trainer`` restores it on the other
  mesh and trains on.
* ONE PEER — a ``(1, 1)`` mesh's DTensor step equals the plain one-peer
  step bit for bit on the CPU (losses and every param, one and two
  microbatches); every other family (moe, ssm, hybrid, encdec, vlm;
  their meshes of several peers in ``test_torch_gspmd_recurrent.py``
  and ``test_torch_gspmd_moe_encdec.py``) takes the DTensor path, one
  step on a ``(1, 1)`` mesh bitwise the plain one.
* THE CLI — ``launch.train --mode gspmd --mesh 1x2`` on two gloo ranks
  trains and writes a checkpoint in the global layout.
"""
import dataclasses
import math
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_config as jax_config
from repro.models import api as japi
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import (CommConfig, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_abstract_mesh, make_device_mesh,
                                     make_mesh)
from repro_torch.launch.train import Trainer
from repro_torch.models.common import tree_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-4b-reduced"
B, S = 8, 32
MESHES = (((2, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 1), ("pod", "data", "model")))

_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import (CommConfig, ModelConfig, RunConfig,
                                      ShapeConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh, make_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.models.common import tree_paths
    from repro_torch.models.convert import from_numpy_params
    from repro_torch.optim import adamw

    rank, world, store, inp, out, tmp = (int(sys.argv[1]),
                                         int(sys.argv[2]), *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    cfg = get_config("qwen1.5-4b-reduced")
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in data["batches"]]

    def run_of(total=2, ckpt=""):
        return RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 8),
                         comm=CommConfig(mode="gspmd"), warmup_steps=1,
                         total_steps=total, checkpoint_dir=ckpt)

    def start(mesh, run):
        params = from_numpy_params(data["params"], "cpu")
        return steps.distribute_state(
            steps.TrainState(params, adamw.init(params), 0),
            steps.train_state_shardings(mesh, run))

    def at_shardings(state, sh):
        """Every param and moment a DTensor at its sharding."""
        ok = True
        for tree, shs in ((state.params, sh.params), (state.opt.mu, sh.opt.mu),
                          (state.opt.nu, sh.opt.nu)):
            for (_, t), (_, s) in zip(tree_paths(tree), tree_paths(shs)):
                ok &= isinstance(t, DTensor) and \\
                    tuple(t.placements) == tuple(s.placements)
        return ok

    def full(state):
        return {p: t.full_tensor().numpy() for p, t in
                tree_paths(state.params)}

    res = {}
    try:
        for dims, axes in data["meshes"][world]:
            run = run_of()
            if len(dims) == 3:          # through the Trainer
                trainer = Trainer(run, make_mesh(dims, axes), device="cpu",
                                  log_fn=lambda line: None, donate=True)
                mesh, step = trainer.mesh, trainer.step_fn
            else:
                mesh = make_device_mesh(dims, axes, "cpu")
                step = steps.make_train_step(run, mesh=mesh, donate=True)
            sh = steps.train_state_shardings(mesh, run)
            state = start(mesh, run)
            losses, placed = [], []
            for i, b in enumerate(batches):
                if i:                       # the second step, recorded
                    with hlo.record() as log:
                        state, m = step(state, b)
                else:
                    state, m = step(state, b)
                losses.append(float(m["loss"]))
                placed.append(at_shardings(state, sh))
            coll = {(op.kind, len(op.ranks)) for op in log.collectives}
            res[dims] = {"losses": losses, "placed": placed,
                         "collectives": coll,
                         "params": full(state), "local": {
                             p: tuple(t.to_local().shape)
                             for p, t in tree_paths(state.params)}}
            if dims == (2, 1):
                ck = CheckpointStore(tmp + "/ck", group=dist.group.WORLD)
                ck.save(2, state)
                other = make_device_mesh((1, 2), ("data", "model"), "cpu")
                back = ck.restore(2, steps.abstract_train_state(run),
                                  device="cpu",
                                  shardings=steps.train_state_shardings(
                                      other, run))
                same = True
                for tree, ref in ((back.params, state.params),
                                  (back.opt.mu, state.opt.mu),
                                  (back.opt.nu, state.opt.nu)):
                    for (_, got), (_, want) in zip(tree_paths(tree),
                                                   tree_paths(ref)):
                        blk = sharding.block_slices(
                            want.shape, other, got.placements)
                        same &= torch.equal(got.to_local(),
                                            want.full_tensor()[blk])
                res["restore_1x2"] = (same, back.opt.count, back.step)
                res["saved"] = full(state)
                # a Trainer on (1, 2) restores that checkpoint, trains on
                tr = Trainer(run_of(3, tmp + "/ck"),
                             make_mesh((1, 2), ("data", "model")),
                             device="cpu", log_fn=lambda line: None,
                             donate=True)
                o = tr.run_loop()
                tr.close()
                res["resumed"] = (o["losses"], o["state"].step)
            if len(dims) == 3:
                trainer.close()
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')

_JAX = textwrap.dedent('''
    import math, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro.configs.registry import get_config
    from repro.launch import steps
    from repro.models.common import tree_paths
    from repro.optim import adamw

    inp, out = sys.argv[1:]
    with open(inp, "rb") as f:
        data = pickle.load(f)
    cfg = get_config("qwen1.5-4b-reduced")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 8),
                    comm=CommConfig(mode="gspmd"), warmup_steps=1,
                    total_steps=2)
    res = {}
    for dims, axes in data["meshes"][2] + data["meshes"][4]:
        mesh = jax.make_mesh(
            dims, axes, axis_types=(compat.AxisType.Auto,) * len(axes),
            devices=jax.devices()[:math.prod(dims)])
        with compat.set_mesh(mesh):
            step_fn, state_sh, batch_sh = steps.make_train_step(run, mesh)
            params = jax.tree.map(jnp.asarray, data["params"])
            state = jax.device_put(steps.TrainState(
                params, adamw.init(params), jnp.zeros((), jnp.int32)),
                state_sh)
            batches = [{k: np.asarray(v, np.int32) for k, v in b.items()}
                       for b in data["batches"]]
            batches = [jax.device_put(b, batch_sh(mesh, b)) for b in batches]
            jitted = jax.jit(step_fn, in_shardings=(
                state_sh, batch_sh(mesh, batches[0])),
                out_shardings=(state_sh, None))
            losses = []
            for b in batches:
                state, m = jitted(state, b)
                losses.append(float(m["loss"]))
        res[dims] = {"losses": losses,
                     "params": {p: np.asarray(x)
                                for p, x in tree_paths(state.params)},
                     "local": {p: tuple(x.addressable_shards[0].data.shape)
                               for p, x in tree_paths(state.params)}}
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def init():
    jcfg = jax_config(ARCH)
    npp = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    batches = [{k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int64)
                for k in ("tokens", "labels")} for _ in range(2)]
    return npp, batches


@pytest.fixture(scope="module")
def runs(init, tmp_path_factory):
    """Gloo worlds of 2 peers ((2, 1), (1, 2) and the checkpoints) and 4
    ((2, 2), (2, 2, 1)), the CLI on 2 ranks, and the reference on 4 host
    devices, all started together. Returns every rank's results, the
    reference's and the CLI's checkpoint directory."""
    tmp = tmp_path_factory.mktemp("gspmd")
    npp, batches = init
    meshes = {2: [m for m in MESHES if math.prod(m[0]) == 2],
              4: [m for m in MESHES if math.prod(m[0]) == 4]}
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"params": npp, "batches": batches, "meshes": meshes}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world in (2, 4):
        for r in range(world):
            procs[world, r] = subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), str(world),
                 str(tmp / f"store{world}"), str(inp),
                 str(tmp / f"out{world}_{r}.pkl"), str(tmp)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = _free_port()
    cli = tmp / "cli"
    for r in range(2):
        procs["cli", r] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
             "--device", "cpu", "--steps", "2", "--global-batch", "4",
             "--seq-len", "16", "--mode", "gspmd", "--mesh", "1x2",
             "--ckpt", str(cli)],
            env=dict(env, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs["jax"] = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(inp), str(tmp / "jax.pkl")],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    failed = {k: logs[k][-3000:] for k, p in procs.items() if p.returncode}
    assert not failed, failed
    outs = {}
    for world in (2, 4):
        for r in range(world):
            with open(tmp / f"out{world}_{r}.pkl", "rb") as f:
                outs[world, r] = pickle.load(f)
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return outs, ref, tmp, logs["cli", 0]


@pytest.mark.parametrize("dims", [m[0] for m in MESHES],
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_gspmd_trains_like_reference(runs, dims):
    """Two steps: losses at 1e-4 / 1e-3 of the reference's, params at
    atol 1e-5 / rtol 1e-4, every peer the same."""
    outs, ref, _, _ = runs
    world = math.prod(dims)
    want = ref[dims]
    for r in range(world):
        got = outs[world, r][dims]
        assert abs(got["losses"][0] - want["losses"][0]) < 1e-4, \
            (got["losses"], want["losses"])
        assert abs(got["losses"][1] - want["losses"][1]) < 1e-3, \
            (got["losses"], want["losses"])
        assert got["losses"] == outs[world, 0][dims]["losses"]
        assert got["params"].keys() == want["params"].keys()
        for path, leaf in got["params"].items():
            np.testing.assert_allclose(leaf, want["params"][path], atol=1e-5,
                                       rtol=1e-4, err_msg=path)
            np.testing.assert_array_equal(
                leaf, outs[world, 0][dims]["params"][path])


@pytest.mark.parametrize("dims", [m[0] for m in MESHES],
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_gspmd_state_stays_at_param_shardings(runs, dims):
    """Every param and moment is a DTensor at its ``param_shardings``
    placements after each step; each peer's local block has the shape
    of the reference's addressable shard."""
    outs, ref, _, _ = runs
    world = math.prod(dims)
    for r in range(world):
        got = outs[world, r][dims]
        assert got["placed"] == [True, True]
        assert got["local"] == ref[dims]["local"]
    # a mesh of more than one peer shards something: FSDP over data, TP
    # over model
    full = {p: a.shape for p, a in ref[dims]["params"].items()}
    assert any(got["local"][p] != full[p] for p in full)


@pytest.mark.parametrize("dims", [m[0] for m in MESHES],
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_gspmd_collectives_are_dtensors(runs, dims):
    """``hlo_analysis.record()`` sees the collectives DTensor issues in a
    step: FSDP's all-gathers of the params and reduce-scatters of the
    gradients over ``data`` (2 peers), TP's over ``model``, and the
    global norm's all-reduces; every group is one mesh dim's (2 peers)
    or the flattened DP axes'."""
    outs, _, _, _ = runs
    got = outs[math.prod(dims), 0][dims]["collectives"]
    kinds = {k for k, _ in got}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds, got
    assert {n for _, n in got} == {2}, got


def test_gspmd_checkpoint_is_mesh_agnostic(runs, init):
    """Saved on (2, 1): every peer's restored block on (1, 2) equals the
    saved state's bit for bit (params, both moments, the counters); the
    file restores onto one peer as the global state; a Trainer on (1, 2)
    resumes from it at step 2 and trains a third step."""
    outs, _, tmp, _ = runs
    for r in range(2):
        same, count, step = outs[2, r]["restore_1x2"]
        assert same and (count, step) == (2, 2)
        losses, final = outs[2, r]["resumed"]
        assert final == 3 and len(losses) == 1 and np.isfinite(losses[0])
    run = RunConfig(model=get_config(ARCH),
                    shape=ShapeConfig("t", "train", S, B),
                    comm=CommConfig(mode="gspmd"))
    saved = outs[2, 0]["saved"]
    ck = CheckpointStore(str(tmp / "ck"))
    assert ck.latest_step() == 3        # the resumed Trainer saved step 3
    one = ck.restore(2, steps.abstract_train_state(run), device="cpu")
    for path, leaf in tree_paths(one.params):
        np.testing.assert_array_equal(leaf.numpy(), saved[path],
                                      err_msg=path)
    assert (one.opt.count, one.step) == (2, 2)


def test_gspmd_cli_on_two_ranks(runs):
    """``launch.train --mode gspmd --mesh 1x2`` on two gloo ranks trains
    two steps and writes its checkpoint in the global layout."""
    _, _, tmp, log = runs
    assert "final loss:" in log, log
    ck = CheckpointStore(str(tmp / "cli"))
    assert ck.latest_step() == 2
    run = RunConfig(model=get_config(ARCH),
                    shape=ShapeConfig("t", "train", 16, 4),
                    comm=CommConfig(mode="gspmd"))
    one = ck.restore(2, steps.abstract_train_state(run), device="cpu")
    want = steps.abstract_train_state(run)
    for (path, got), (_, like) in zip(tree_paths(one.params),
                                      tree_paths(want.params)):
        assert got.shape == like.shape and torch.isfinite(got).all(), path


@pytest.fixture(scope="module")
def group():
    """A one-peer gloo group in this process (no port: HashStore)."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield
    if own:
        dist.destroy_process_group()


@pytest.mark.parametrize("micro", [1, 2])
def test_one_by_one_mesh_equals_one_peer_step(group, micro):
    """The DTensor step on a (1, 1) mesh equals the plain one-peer step
    bit for bit: losses and every param after three steps."""
    run = RunConfig(model=get_config(ARCH),
                    shape=ShapeConfig("t", "train", S, B),
                    comm=CommConfig(mode="gspmd"), total_steps=3,
                    warmup_steps=1, microbatches=micro)
    plain = Trainer(run, device="cpu", log_fn=lambda line: None,
                    donate=True)
    mesh = Trainer(run, make_mesh((1, 1), ("data", "model")), device="cpu",
                   log_fn=lambda line: None, donate=True)
    try:
        assert plain.mesh is None and mesh.mesh is not None
        a, b = plain.run_loop(), mesh.run_loop()
    finally:
        plain.close()
        mesh.close()
    assert a["losses"] == b["losses"]
    for (path, x), (_, y) in zip(tree_paths(a["state"].params),
                                 tree_paths(b["state"].params)):
        assert torch.equal(x, y.full_tensor()), path


@pytest.mark.parametrize("arch", ["mixtral-8x7b-reduced",
                                  "rwkv6-7b-reduced",
                                  "recurrentgemma-9b-reduced",
                                  "whisper-tiny-reduced",
                                  "llava-next-mistral-7b-reduced"])
def test_unthreaded_families_raise_on_a_mesh(group, arch):
    """No family is left unthreaded: every registered family (moe, ssm,
    hybrid, encdec, vlm here; dense above) takes the DTensor path on a
    (2, 2) mesh, and one step of it on a (1, 1) mesh (a vlm batch's
    patch prefix and an encdec batch's frames placed with the batch)
    equals the plain one-peer step bit for bit, moe's balance loss
    included."""
    run = RunConfig(model=get_config(arch),
                    shape=ShapeConfig("t", "train", S, B),
                    comm=CommConfig(mode="gspmd"))
    two = make_abstract_mesh((2, 2), ("data", "model"))
    assert set(steps.GSPMD_FAMILIES) == set(ModelConfig.FAMILIES)
    assert run.model.family in steps.GSPMD_FAMILIES
    assert steps.uses_dtensor(run, two)
    _one_mesh_step(run)


def _one_mesh_step(run):
    cfg = run.model
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(gen, run, "cpu")
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((B, cfg.num_patches, cfg.d_model),
                                       generator=gen)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.num_frames, cfg.d_model),
                                      generator=gen)
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu")
    placed = steps.distribute_state(state, steps.train_state_shardings(
        mesh, run))
    want, wm = steps.make_train_step_gspmd(run)(state, batch)
    got, gm = steps.make_train_step_gspmd(run, mesh)(placed, batch)
    assert torch.equal(gm["loss"], wm["loss"]) and np.isfinite(
        float(wm["loss"]))
    for (path, x), (_, y) in zip(tree_paths(want.params),
                                 tree_paths(got.params)):
        assert torch.equal(x, y.full_tensor()), path
