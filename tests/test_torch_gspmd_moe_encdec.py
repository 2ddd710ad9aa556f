"""repro_torch's GSPMD steps on DTensor for the moe (mixtral) and encdec
(whisper) families against the JAX reference's jitted
``make_prefill_step`` / ``make_decode_step`` (``serve_specs``'
shardings: params at ``param_shardings``, inputs at ``batch_sharding``,
the cache at ``cache_shardings`` in and out) and
``make_train_step_gspmd``:

* SERVING — gloo peers over ``("data", "model")`` meshes serve one
  prefill of S=20 tokens (per-row ``last_pos``) and three decode steps,
  beside the reference on 4 host devices with the same mesh shapes (a
  JAX subprocess, run beside them): ``mixtral-8x7b-reduced`` on
  ``(1, 2)`` and ``(2, 2)`` (a 0-d ``pos``; its 4 experts split 2 a
  peer over ``model``, its 16-slot window rolled), once more on
  ``(2, 2)`` with ``capacity_factor=1.0`` and a router that sends most
  first choices to expert 0, so the prefill drops tokens on a split
  expert axis; ``whisper-tiny-reduced`` on ``(2, 1)`` and ``(2, 2)`` (a
  ``(B,)`` ``pos``: the learned-position lookup per row). Logits and
  every cache leaf at atol = rtol = 1e-4 on f32; after every decode step
  each leaf is the object the step was given, a DTensor at its
  ``cache_shardings`` placements (whisper's cross K/V included, never
  recomputed). Each prefill calls ``ops.flash_attention`` once per
  attention layer on plain, contiguous local blocks: mixtral's causal,
  whisper's encoder non-causal and its decoder causal.
* TRAINING — three gspmd steps of mixtral-reduced on ``(2, 2)`` and
  whisper-reduced on ``(1, 2)`` (a batch with ``"frames"``) from the
  same params and batches as the reference: losses at 1e-4 / 1e-3,
  final params under ``test_torch_gspmd_recurrent.py``'s rule, every
  peer the same, params and moments at ``param_shardings`` after each
  step, no kernel wrapper called; mixtral's balance plus z-loss at the
  start params, over the global batch, at 1e-5 of the reference's.
* ONE PEER — a ``(1, 1)`` mesh's prefill and decode steps (both ``pos``
  forms) equal ``api.prefill`` and ``api.decode_step`` bit for bit for
  both families.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import api, moe
from repro_torch.models.common import tree_map, tree_paths

try:
    import jax      # the reference runs in a subprocess
except ImportError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, STEPS, B, MAX = 20, 3, 4, 24
TRAIN_S, TRAIN_STEPS = 16, 3
TOL = dict(atol=1e-4, rtol=1e-4)
AXES = ("data", "model")
# name -> (arch, config fields replaced (``capacity_factor``: the moe
# config's), serve meshes, train meshes, decode pos form)
CONFIGS = {
    "moe": ("mixtral-8x7b-reduced", {}, ((1, 2), (2, 2)), ((2, 2),),
            "scalar"),
    "moe_drop": ("mixtral-8x7b-reduced", {"capacity_factor": 1.0},
                 ((2, 2),), (), "scalar"),
    "encdec": ("whisper-tiny-reduced", {}, ((2, 1), (2, 2)), ((1, 2),),
               "rows"),
}
CASES = [(name, dims) for name, c in CONFIGS.items() for dims in c[2]]
TRAIN = [(name, dims) for name, c in CONFIGS.items() for dims in c[3]]

_CONFIG = '''
def config(get_config, arch, repl):
    cfg = get_config(arch)
    repl = dict(repl)
    if "capacity_factor" in repl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=repl.pop("capacity_factor")))
    return dataclasses.replace(cfg, **repl)
'''
exec(_CONFIG)

_WORKER = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.models.convert import from_numpy_params
    from repro_torch.optim import adamw
''') + _CONFIG + textwrap.dedent('''
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    calls = []          # (causal, every input plain and contiguous)
    flash = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((kw["causal"], all(type(t) is torch.Tensor
                                        and t.is_contiguous()
                                        for t in (q, k, v))))
        return flash(q, k, v, **kw)

    ops.flash_attention = counted

    def taken():
        got = list(calls)
        del calls[:]
        return got

    flat = lambda tree: {p: t.full_tensor().numpy()
                         for p, t in tree_paths(tree)}
    as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}

    def at(tree, shardings):
        return all(isinstance(t, DTensor) and tuple(t.placements)
                   == tuple(s.placements) for (_, t), (_, s) in zip(
                       tree_paths(tree), tree_paths(shardings)))

    res = {}
    try:
        for (name, dims), axes in data["serve"][world]:
            arch, repl, _, _, form = data["configs"][name]
            cfg = config(get_config, arch, repl)
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "s", "decode", data["max"], data["B"]),
                comm=CommConfig(mode="gspmd"))
            mesh = make_device_mesh(dims, axes, "cpu")
            params = sharding.distribute_tree(
                from_numpy_params(data["params"][name], "cpu"),
                sharding.param_shardings(mesh, api.specs(cfg)))
            place = lambda t: sharding.distribute_tree(
                t, sharding.batch_sharding(mesh, t))
            taken()
            logits, cache = steps.make_prefill_step(run, mesh)(
                params, place(as_t(data["prefill"][name])))
            got = {"prefill": logits.full_tensor().numpy(),
                   "prefill_calls": taken(), "prefill_cache": flat(cache)}
            grown = api.grow_cache(cfg, tree_map(lambda t: t.full_tensor(),
                                                 cache), data["max"])
            csh = sharding.cache_shardings(mesh, grown)
            decode = steps.make_decode_step(run, mesh)
            c = sharding.distribute_tree(grown, csh)
            outs, kept = [], []
            for dec in data["decode"][name]:
                lg, c2 = decode(params, c, place(as_t(dec)))
                outs.append(lg.full_tensor().numpy())
                kept.append(at(c2, csh) and all(
                    a is b for (_, a), (_, b) in zip(tree_paths(c2),
                                                     tree_paths(c))))
                c = c2
            got["decode"] = {"logits": outs, "kept": kept,
                             "calls": taken(), "cache": flat(c)}
            res["serve", name, dims] = got
        for (name, dims), axes in data["train"][world]:
            arch, repl, _, _, _ = data["configs"][name]
            cfg = config(get_config, arch, repl)
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "t", "train", data["train_s"], data["B"]),
                comm=CommConfig(mode="gspmd"), warmup_steps=1,
                total_steps=data["train_steps"])
            mesh = make_device_mesh(dims, axes, "cpu")
            sh = steps.train_state_shardings(mesh, run)
            p0 = from_numpy_params(data["params"][name], "cpu")
            state = steps.distribute_state(
                steps.TrainState(p0, adamw.init(p0), 0), sh)
            batches = [as_t(b) for b in data["batches"][name]]
            with torch.no_grad(), implicit_replication():
                _, aux = api.loss(state.params, steps._placed(
                    batches[0], mesh), cfg, sharding.make_shard_fn(mesh))
            aux = {k: float(v.full_tensor()) for k, v in aux.items()}
            step = steps.make_train_step(run, mesh=mesh, donate=True)
            taken()
            losses, placed = [], []
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                placed.append(at(state.params, sh.params)
                              and at(state.opt.mu, sh.opt.mu)
                              and at(state.opt.nu, sh.opt.nu))
            res["train", name, dims] = {"losses": losses, "at": placed,
                                        "calls": taken(), "aux": aux,
                                        "params": flat(state.params)}
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')

_JAX = textwrap.dedent('''
    import dataclasses, math, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro.configs.registry import get_config
    from repro.launch import steps
    from repro.launch.sharding import (batch_sharding, cache_shardings,
                                       param_shardings)
    from repro.models import api
    from repro.models.common import tree_paths
    from repro.optim import adamw
''') + _CONFIG + textwrap.dedent('''
    part, inp, out = sys.argv[1:]
    with open(inp, "rb") as f:
        data = pickle.load(f)
    i32 = lambda t: {k: np.asarray(v, np.int32) if v.dtype == np.int64
                     else v for k, v in t.items()}
    flat = lambda tree: {p: np.asarray(x) for p, x in tree_paths(tree)}
    res = {}
    for (name, dims), axes in data[part][2] + data[part][4]:
        arch, repl, _, _, _ = data["configs"][name]
        cfg = config(get_config, arch, repl)
        mesh = jax.make_mesh(
            dims, axes, axis_types=(compat.AxisType.Auto,) * len(axes),
            devices=jax.devices()[:math.prod(dims)])
        with compat.set_mesh(mesh):
            params = jax.tree.map(jnp.asarray, data["params"][name])
            if part == "train":
                run = RunConfig(model=cfg, shape=ShapeConfig(
                    "t", "train", data["train_s"], data["B"]),
                    comm=CommConfig(mode="gspmd"), warmup_steps=1,
                    total_steps=data["train_steps"])
                step_fn, state_sh, batch_sh = steps.make_train_step(run,
                                                                    mesh)
                batches = [i32(b) for b in data["batches"][name]]
                _, aux = jax.jit(lambda p, b: api.loss(p, b, cfg))(
                    params, batches[0])
                state = jax.device_put(steps.TrainState(
                    params, adamw.init(params), jnp.zeros((), jnp.int32)),
                    state_sh)
                jitted = jax.jit(step_fn, in_shardings=(
                    state_sh, batch_sh(mesh, batches[0])),
                    out_shardings=(state_sh, None))
                losses = []
                for b in batches:
                    state, m = jitted(state, jax.device_put(
                        b, batch_sh(mesh, b)))
                    losses.append(float(m["loss"]))
                res[name, dims] = {"losses": losses,
                                   "aux": {k: float(v)
                                           for k, v in aux.items()},
                                   "params": flat(state.params)}
                continue
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "s", "decode", data["max"], data["B"]),
                comm=CommConfig(mode="gspmd"))
            psh = param_shardings(mesh, api.specs(cfg), fsdp=True)
            params = jax.device_put(params, psh)
            pre = i32(data["prefill"][name])
            logits, cache = jax.jit(steps.make_prefill_step(run, mesh),
                                    in_shardings=(psh, batch_sharding(
                                        mesh, pre)))(params, pre)
            got = {"prefill": np.asarray(logits),
                   "prefill_cache": flat(cache)}
            grown = api.grow_cache(cfg, cache, data["max"])
            csh = cache_shardings(mesh, grown)
            decs = [i32(d) for d in data["decode"][name]]
            dec_fn = jax.jit(steps.make_decode_step(run, mesh),
                             in_shardings=(psh, csh, batch_sharding(
                                 mesh, decs[0])),
                             out_shardings=(None, csh))
            c = jax.device_put(grown, csh)
            outs = []
            for dec in decs:
                lg, c = dec_fn(params, c, dec)
                outs.append(np.asarray(lg))
            got["decode"] = {"logits": outs, "cache": flat(c)}
            res[name, dims] = got
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def _config(name):
    arch, repl, _, _, _ = CONFIGS[name]
    return config(get_config, arch, repl)


def _inputs(name, cfg) -> tuple:
    """One prefill batch (per-row prompt ends; whisper's frames) and
    three decode batches at the config's ``pos`` form: a 0-d ``pos``
    after the padded prompt, or a ``(B,)`` one after each row's end."""
    rng = np.random.default_rng(7)
    last = np.array([S - 1 - (i % 4) for i in range(B)])
    pre = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "last_pos": last}
    if cfg.family == "encdec":
        pre["frames"] = rng.normal(size=(B, cfg.num_frames, cfg.d_model)
                                   ).astype(np.float32)
    form = CONFIGS[name][4]
    dec = [{"token": rng.integers(0, cfg.vocab_size, (B,)),
            "pos": np.array(S + i) if form == "scalar" else last + 1 + i}
           for i in range(STEPS)]
    return pre, dec


def _params(name, cfg) -> dict:
    """The port's seeded init (the reference's layout and scales) with
    noise on every leaf; the dropping config's router leans on expert
    0, so most first choices go there."""
    rng = np.random.default_rng(1)
    params = tree_map(
        lambda t: t.numpy() + rng.normal(scale=0.05, size=tuple(
            t.shape)).astype(np.float32),
        api.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    if name == "moe_drop":
        params["layers"]["moe"]["router"][..., 0] += 2.0
    return params


def _train_batches(cfg) -> list:
    rng = np.random.default_rng(3)
    out = []
    for _ in range(TRAIN_STEPS):
        b = {k: rng.integers(0, cfg.vocab_size, (B, TRAIN_S))
             for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            b["frames"] = rng.normal(size=(B, cfg.num_frames, cfg.d_model)
                                     ).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Gloo worlds of 2 and 4 peers over every serve and train case, and
    the reference's serve and train steps on 4 host devices (two JAX
    subprocesses), all started together."""
    if jax is None:
        pytest.skip("the JAX reference is not installed")
    tmp = tmp_path_factory.mktemp("gspmd_moe_encdec")
    params, pre, dec, batches = {}, {}, {}, {}
    for name in CONFIGS:
        cfg = _config(name)
        params[name] = _params(name, cfg)
        pre[name], dec[name] = _inputs(name, cfg)
        batches[name] = _train_batches(cfg)
    by_world = lambda cases: {w: [((n, d), AXES) for n, d in cases
                                  if math.prod(d) == w] for w in (2, 4)}
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"configs": CONFIGS, "params": params, "prefill": pre,
                     "decode": dec, "batches": batches,
                     "serve": by_world(CASES), "train": by_world(TRAIN),
                     "B": B, "max": MAX, "train_s": TRAIN_S,
                     "train_steps": TRAIN_STEPS}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world in (2, 4):
        for r in range(world):
            procs[world, r] = subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), str(world),
                 str(tmp / f"store{world}"), str(inp),
                 str(tmp / f"out{world}_{r}.pkl")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for part in ("serve", "train"):
        procs[part] = subprocess.Popen(
            [sys.executable, "-c", _JAX, part, str(inp),
             str(tmp / f"jax_{part}.pkl")],
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
    ref = {}
    for part in ("serve", "train"):
        with open(tmp / f"jax_{part}.pkl", "rb") as f:
            ref[part] = pickle.load(f)
    return outs, ref


def _ids(cases):
    return [f"{n}-{'x'.join(map(str, d))}" for n, d in cases]


def _peers(outs, kind, name, dims):
    world = math.prod(dims)
    return [outs[world, r][kind, name, dims] for r in range(world)]


def _close_trees(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), (what, got.keys(), want.keys())
    for path in want:
        np.testing.assert_allclose(got[path], want[path],
                                   err_msg=f"{what} {path}", **TOL)


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_serve_steps_match_reference(runs, name, dims):
    """Prefill logits and cache (whisper's self pages and cross K/V),
    then three decode steps (logits, and the cache after the third):
    the reference's values on every peer."""
    outs, ref = runs
    want = ref["serve"][name, dims]
    for got in _peers(outs, "serve", name, dims):
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
        _close_trees(got["prefill_cache"], want["prefill_cache"], "prefill")
        for i, (g, w) in enumerate(zip(got["decode"]["logits"],
                                       want["decode"]["logits"])):
            np.testing.assert_allclose(g, w, err_msg=f"decode {i}", **TOL)
        _close_trees(got["decode"]["cache"], want["decode"]["cache"],
                     "decode")


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_decode_keeps_the_given_cache_at_its_shardings(runs, name, dims):
    """After every decode step each cache leaf is the object the step was
    given (self pages written in place, whisper's cross K/V read and
    never recomputed), a DTensor at its ``cache_shardings``
    placements."""
    outs, _ = runs
    for got in _peers(outs, "serve", name, dims):
        assert got["decode"]["kept"] == [True] * STEPS


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_prefill_runs_flash_on_local_blocks(runs, name, dims):
    """A prefill calls the flash wrapper once per attention layer on
    plain, contiguous tensors (each peer's local blocks): mixtral's
    causal, whisper's encoder non-causal then its decoder causal; a
    decode step calls it never."""
    outs, _ = runs
    cfg = _config(name)
    want = [True] * cfg.num_layers
    if cfg.family == "encdec":
        want = [False] * cfg.encoder_layers + want
    for got in _peers(outs, "serve", name, dims):
        calls = got["prefill_calls"]
        assert [causal for causal, _ in calls] == want, calls
        assert all(plain for _, plain in calls), calls
        assert got["decode"]["calls"] == []


def test_dropping_config_drops_tokens():
    """The dropping case's prefill really drops: in the first layer,
    some expert of some row gets more entries than its capacity (here
    checked on the plain path, whose routing is per row, the same on
    every mesh)."""
    cfg = _config("moe_drop")
    c = moe.capacity(S, cfg)
    params = tree_map(torch.from_numpy, _params("moe_drop", cfg))
    pre, _ = _inputs("moe_drop", cfg)
    seen = []
    real = moe._ranks_within_expert

    def spy(eids):
        ranks = real(eids)
        seen.append(int((ranks >= c).sum()))
        return ranks

    moe._ranks_within_expert = spy
    try:
        api.prefill(params, {k: torch.as_tensor(v) for k, v in pre.items()},
                    cfg)
    finally:
        moe._ranks_within_expert = real
    assert len(seen) == cfg.num_layers and seen[0] > 0, seen


@pytest.mark.parametrize("name,dims", TRAIN, ids=_ids(TRAIN))
def test_gspmd_trains_like_reference(runs, name, dims):
    """Three steps: losses at 1e-4 / 1e-3 of the reference's (mixtral's
    with its balance and z-loss), params at atol 1e-5 / rtol 1e-4 (at
    most 0.1% of a leaf off, every element within 3 lr:
    ``test_torch_gspmd_recurrent.py``'s rule), every peer the same;
    params and moments stay at ``param_shardings``; no kernel wrapper is
    called. mixtral's aux loss at the start params, a mean over the
    global batch, is the reference's to 1e-5 (per-peer means would
    differ on any mesh whose ``data`` > 1)."""
    outs, ref = runs
    want = ref["train"][name, dims]
    peers = _peers(outs, "train", name, dims)
    lr = RunConfig(model=_config(name), shape=ShapeConfig(
        "t", "train", TRAIN_S, B)).lr
    for got in peers:
        assert got["aux"].keys() == want["aux"].keys()
        for k, v in want["aux"].items():
            assert abs(got["aux"][k] - v) <= 1e-5 * max(1.0, abs(v)), \
                (k, got["aux"], want["aux"])
        assert abs(got["losses"][0] - want["losses"][0]) < 1e-4, \
            (got["losses"], want["losses"])
        assert all(abs(g - w) < 1e-3 for g, w in zip(got["losses"][1:],
                                                     want["losses"][1:])), \
            (got["losses"], want["losses"])
        assert got["losses"] == peers[0]["losses"]
        assert got["at"] == [True] * TRAIN_STEPS and got["calls"] == []
        assert got["params"].keys() == want["params"].keys()
        for path, leaf in got["params"].items():
            w = want["params"][path]
            np.testing.assert_allclose(leaf, w, atol=3 * lr, rtol=0,
                                       err_msg=path)
            off = np.abs(leaf - w) > 1e-5 + 1e-4 * np.abs(w)
            assert off.mean() <= 1e-3, (path, int(off.sum()))
            np.testing.assert_array_equal(leaf, peers[0]["params"][path])


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


@pytest.mark.parametrize("name", ["moe", "encdec"])
def test_one_by_one_mesh_equals_plain_steps(group, name):
    """On a (1, 1) mesh the DTensor prefill and decode steps (a 0-d and a
    ``(B,)`` ``pos``) equal ``api.prefill`` and ``api.decode_step`` bit
    for bit: logits and every cache leaf."""
    cfg = _config(name)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", "decode", MAX, B),
                    comm=CommConfig(mode="gspmd"))
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    pre, _ = _inputs(name, cfg)
    as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    pre = as_t(pre)
    mesh = make_device_mesh((1, 1), AXES, "cpu")
    place = lambda t: sharding.distribute_tree(
        t, sharding.batch_sharding(mesh, t))
    dparams = sharding.distribute_tree(params, sharding.param_shardings(
        mesh, api.specs(cfg)))
    same = lambda a, b: all(torch.equal(x.full_tensor(), y) for (_, x), (
        _, y) in zip(tree_paths(a), tree_paths(b)))
    lp, cp = api.prefill(params, pre, cfg)
    lm, cm = steps.make_prefill_step(run, mesh)(dparams, place(pre))
    assert torch.equal(lm.full_tensor(), lp) and same(cm, cp)
    grown = api.grow_cache(cfg, cp, MAX)
    decode = steps.make_decode_step(run, mesh)
    gen = torch.Generator().manual_seed(2)
    for pos in (lambda i: torch.tensor(S + i),
                lambda i: pre["last_pos"] + 1 + i):
        plain = tree_map(torch.clone, grown)
        placed = sharding.distribute_tree(grown, sharding.cache_shardings(
            mesh, grown))
        for i in range(STEPS):
            d = {"token": torch.randint(0, cfg.vocab_size, (B,),
                                        generator=gen), "pos": pos(i)}
            l1, plain = api.decode_step(params, plain, d, cfg)
            l2, placed = decode(dparams, placed, place(d))
            assert torch.equal(l2.full_tensor(), l1)
        assert same(placed, plain)
