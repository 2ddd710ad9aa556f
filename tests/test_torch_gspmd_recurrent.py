"""repro_torch's GSPMD steps on DTensor for the recurrent families (rwkv6:
``ssm``, recurrentgemma: ``hybrid``) against the JAX reference's jitted
``make_prefill_step`` / ``make_decode_step`` (``serve_specs``'
shardings: params at ``param_shardings``, inputs at ``batch_sharding``,
the cache at ``cache_shardings`` in and out) and
``make_train_step_gspmd``:

* SERVING — gloo peers over ``(2, 1)``, ``(1, 2)``, ``(2, 2)``
  ``("data", "model")`` and ``(2, 2, 1)`` ``("pod", "data", "model")``
  serve one prefill of S=20 tokens (per-row ``last_pos``) and three
  decode steps (a 0-d ``pos`` after the prompt; the dense family's
  ``(B,)`` form is ``test_torch_gspmd_serve.py``'s), beside the
  reference on 4 host devices with the same mesh shapes (a JAX
  subprocess, run beside them). ``rwkv6-7b-reduced`` and
  ``recurrentgemma-9b-reduced`` at B=4 on every mesh; recurrentgemma
  with ``num_layers=8`` (two groups and two unstacked ``tail`` blocks)
  on ``(2, 2)``; rwkv6 with ``d_model=48`` (3 heads, which do not split
  over ``model`` = 2, while the state's hs = 16 does) on ``(1, 2)``.
  The prompt is longer than recurrentgemma's 16-token window, so the
  prefill pages are rolled and each decode step overwrites a rolling
  slot of a window split over ``model``. Logits and every state leaf are held at
  the port's JAX-parity tolerances (atol = rtol = 1e-4 on f32); after
  the prefill and after every decode step each state leaf is a DTensor
  at its ``cache_shardings`` placements. Each prefill runs
  ``ops.wkv6`` once per rwkv6 layer, ``ops.rglru`` once per RG-LRU
  block and ``ops.flash_attention`` once per local-attention block, and
  each decode step ``ops.wkv6`` once per layer, all on plain,
  contiguous tensors (each peer's local blocks).
* TRAINING — both families three steps on ``(1, 2)`` and ``(2, 2)``
  from the same params and batches as the reference: losses at 1e-4 /
  1e-3 (``test_torch_gspmd.py``'s bounds), final params at atol 1e-5 /
  rtol 1e-4 under the rule ``test_torch_train_families.py`` holds three
  steps of these families to: at most 0.1% of a leaf off that bound,
  every element within 3 lr (an element whose gradients change sign
  from step to step has a first moment small beside the second, and
  its Adam step follows f32 noise: against the reference run with
  XLA's CPU threading off, single elements differ by up to 2.6e-5),
  every peer the same, every param and both moments at their
  ``param_shardings`` placements after each step, and no kernel
  wrapper called (train mode runs the plain scans inside the same
  ``local_map``). The params are the port's seeded init with noise on
  every leaf (``api.init``), shared with the reference.
* ONE PEER — a ``(1, 1)`` mesh's train, prefill and decode steps equal
  the plain steps bit for bit; ``ops.wkv6`` and ``ops.rglru`` refuse a
  DTensor.
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
from repro_torch.kernels import ops
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import api
from repro_torch.models.common import tree_map, tree_paths

try:
    import jax      # the reference runs in a subprocess
except ImportError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, STEPS, B = 20, 3, 4
TRAIN_S, TRAIN_STEPS = 16, 3
TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = {(2, 1): ("data", "model"), (1, 2): ("data", "model"),
          (2, 2): ("data", "model"), (2, 2, 1): ("pod", "data", "model")}
# name -> (arch, config fields replaced, serve meshes, train meshes)
CONFIGS = {
    "ssm": ("rwkv6-7b-reduced", {}, tuple(MESHES), ((1, 2), (2, 2))),
    "hybrid": ("recurrentgemma-9b-reduced", {}, tuple(MESHES),
               ((1, 2), (2, 2))),
    "hybrid_tail": ("recurrentgemma-9b-reduced", {"num_layers": 8},
                    ((2, 2),), ()),
    "ssm_3heads": ("rwkv6-7b-reduced", {"d_model": 48}, ((1, 2),), ()),
}
CASES = [(name, dims) for name, c in CONFIGS.items() for dims in c[2]]
TRAIN = [(name, dims) for name, c in CONFIGS.items() for dims in c[3]]

_WORKER = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, steps
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.models.convert import from_numpy_params
    from repro_torch.optim import adamw

    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    calls = []          # (wrapper, every input plain and contiguous)

    def counting(name):
        fn = getattr(ops, name)

        def counted(*args, **kw):
            calls.append((name, all(type(t) is torch.Tensor
                                    and t.is_contiguous() for t in args)))
            return fn(*args, **kw)
        setattr(ops, name, counted)

    for name in ("wkv6", "rglru", "flash_attention"):
        counting(name)

    def taken():
        got = list(calls)
        del calls[:]
        return got

    flat = lambda tree: {p: t.full_tensor().numpy()
                         for p, t in tree_paths(tree)}

    def at(tree, shardings):
        return all(isinstance(t, DTensor) and tuple(t.placements)
                   == tuple(s.placements) for (_, t), (_, s) in zip(
                       tree_paths(tree), tree_paths(shardings)))

    res = {}
    try:
        for (name, dims), axes in data["serve"][world]:
            arch, repl, _, _ = data["configs"][name]
            cfg = dataclasses.replace(get_config(arch), **repl)
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "s", "decode", data["S"] + data["steps"], data["B"]),
                comm=CommConfig(mode="gspmd"))
            mesh = make_device_mesh(dims, axes, "cpu")
            params = sharding.distribute_tree(
                from_numpy_params(data["params"][name], "cpu"),
                sharding.param_shardings(mesh, api.specs(cfg)))
            place = lambda t: sharding.distribute_tree(
                t, sharding.batch_sharding(mesh, t))
            as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
            taken()
            logits, cache = steps.make_prefill_step(run, mesh)(
                params, place(as_t(data["prefill"][name])))
            csh = sharding.cache_shardings(mesh, cache)
            got = {"prefill": logits.full_tensor().numpy(),
                   "prefill_calls": taken(), "prefill_at": at(cache, csh),
                   "prefill_cache": flat(cache)}
            full = tree_map(lambda t: t.full_tensor(), cache)
            decode = steps.make_decode_step(run, mesh)
            c = sharding.distribute_tree(full, csh)
            outs, placed, per_step = [], [], []
            for dec in data["decode"][name]:
                lg, c = decode(params, c, place(as_t(dec)))
                outs.append(lg.full_tensor().numpy())
                placed.append(at(c, csh))
                per_step.append(taken())
            got["decode"] = {"logits": outs, "at": placed,
                             "calls": per_step, "cache": flat(c)}
            res["serve", name, dims] = got
        for (name, dims), axes in data["train"][world]:
            arch, repl, _, _ = data["configs"][name]
            cfg = dataclasses.replace(get_config(arch), **repl)
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "t", "train", data["train_s"], data["B"]),
                comm=CommConfig(mode="gspmd"), warmup_steps=1,
                total_steps=data["train_steps"])
            mesh = make_device_mesh(dims, axes, "cpu")
            sh = steps.train_state_shardings(mesh, run)
            p0 = from_numpy_params(data["params"][name], "cpu")
            state = steps.distribute_state(
                steps.TrainState(p0, adamw.init(p0), 0), sh)
            step = steps.make_train_step(run, mesh=mesh, donate=True)
            taken()
            losses, placed = [], []
            for b in data["batches"]:
                state, m = step(state, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
                losses.append(float(m["loss"]))
                placed.append(at(state.params, sh.params)
                              and at(state.opt.mu, sh.opt.mu)
                              and at(state.opt.nu, sh.opt.nu))
            res["train", name, dims] = {"losses": losses, "at": placed,
                                        "calls": taken(),
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

    part, inp, out = sys.argv[1:]
    with open(inp, "rb") as f:
        data = pickle.load(f)
    i32 = lambda t: {k: np.asarray(v, np.int32) if v.dtype == np.int64
                     else v for k, v in t.items()}
    flat = lambda tree: {p: np.asarray(x) for p, x in tree_paths(tree)}
    res = {}
    for (name, dims), axes in data[part][2] + data[part][4]:
        arch, repl, _, _ = data["configs"][name]
        cfg = dataclasses.replace(get_config(arch), **repl)
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
                state = jax.device_put(steps.TrainState(
                    params, adamw.init(params), jnp.zeros((), jnp.int32)),
                    state_sh)
                batches = [i32(b) for b in data["batches"]]
                jitted = jax.jit(step_fn, in_shardings=(
                    state_sh, batch_sh(mesh, batches[0])),
                    out_shardings=(state_sh, None))
                losses = []
                for b in batches:
                    state, m = jitted(state, jax.device_put(
                        b, batch_sh(mesh, b)))
                    losses.append(float(m["loss"]))
                res[name, dims] = {"losses": losses,
                                   "params": flat(state.params)}
                continue
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "s", "decode", data["S"] + data["steps"], data["B"]),
                comm=CommConfig(mode="gspmd"))
            psh = param_shardings(mesh, api.specs(cfg), fsdp=True)
            params = jax.device_put(params, psh)
            pre = i32(data["prefill"][name])
            logits, cache = jax.jit(steps.make_prefill_step(run, mesh),
                                    in_shardings=(psh, batch_sharding(
                                        mesh, pre)))(params, pre)
            got = {"prefill": np.asarray(logits),
                   "prefill_cache": flat(cache)}
            csh = cache_shardings(mesh, cache)
            decs = data["decode"][name]
            dec_fn = jax.jit(steps.make_decode_step(run, mesh),
                             in_shardings=(psh, csh, batch_sharding(
                                 mesh, i32(decs[0]))),
                             out_shardings=(None, csh))
            c = jax.device_put(cache, csh)
            outs = []
            for dec in decs:
                lg, c = dec_fn(params, c, i32(dec))
                outs.append(np.asarray(lg))
            got["decode"] = {"logits": outs, "cache": flat(c)}
            res[name, dims] = got
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def _config(name):
    arch, repl, _, _ = CONFIGS[name]
    return dataclasses.replace(get_config(arch), **repl)


def _inputs(vocab: int) -> tuple:
    """One prefill batch (per-row prompt ends) and three decode batches
    at a 0-d ``pos`` after the prompt."""
    rng = np.random.default_rng(7)
    last = np.array([S - 1 - (i % 4) for i in range(B)])
    pre = {"tokens": rng.integers(0, vocab, (B, S)), "last_pos": last}
    dec = [{"token": rng.integers(0, vocab, (B,)), "pos": np.array(S + i)}
           for i in range(STEPS)]
    return pre, dec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Gloo worlds of 2 and 4 peers over every serve and train case, and
    the reference's serve and train steps on 4 host devices (two JAX
    subprocesses), all started together."""
    if jax is None:
        pytest.skip("the JAX reference is not installed")
    tmp = tmp_path_factory.mktemp("gspmd_recurrent")
    params, pre, dec = {}, {}, {}
    for name in CONFIGS:
        cfg = _config(name)
        rng = np.random.default_rng(1)
        # the port's seeded init (the reference's layout and scales) with
        # noise on every leaf: the zero-initialised mixes, decays and
        # biases would otherwise hide a misplaced block
        params[name] = tree_map(
            lambda t: t.numpy() + rng.normal(scale=0.05, size=tuple(
                t.shape)).astype(np.float32),
            api.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
        pre[name], dec[name] = _inputs(cfg.vocab_size)
    rng = np.random.default_rng(3)
    batches = [{k: rng.integers(0, 256, (B, TRAIN_S)).astype(np.int64)
                for k in ("tokens", "labels")} for _ in range(TRAIN_STEPS)]
    by_world = lambda cases: {w: [((n, d), MESHES[d]) for n, d in cases
                                  if math.prod(d) == w] for w in (2, 4)}
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"configs": CONFIGS, "params": params, "prefill": pre,
                     "decode": dec, "batches": batches,
                     "serve": by_world(CASES), "train": by_world(TRAIN),
                     "S": S, "steps": STEPS, "B": B, "train_s": TRAIN_S,
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
    logs = {k: p.communicate(timeout=400)[0] for k, p in procs.items()}
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
    """Prefill logits and state, then three decode steps (logits, and the
    state after the third): the reference's values on every peer."""
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
def test_state_sits_at_cache_shardings(runs, name, dims):
    """After the prefill and after every decode step each state leaf
    (WKV states, token shifts, RG-LRU states, conv tails, rolling
    attention pages) is a DTensor at its ``cache_shardings``
    placements: the reference's ``out_shardings``."""
    outs, _ = runs
    for got in _peers(outs, "serve", name, dims):
        assert got["prefill_at"]
        assert got["decode"]["at"] == [True] * STEPS


def _kernel_calls(cfg, kind: str) -> list:
    """The wrapper calls one prefill or decode step makes, in order."""
    if cfg.family == "ssm":
        return ["wkv6"] * cfg.num_layers
    if kind == "decode":
        return []
    pattern = cfg.block_pattern
    blocks = [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
    return ["rglru" if k == "rglru" else "flash_attention" for k in blocks]


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_kernels_run_on_local_blocks(runs, name, dims):
    """A prefill calls ``ops.wkv6`` once per rwkv6 layer, ``ops.rglru``
    once per RG-LRU block and ``ops.flash_attention`` once per
    local-attention block, a decode step ``ops.wkv6`` once per rwkv6
    layer (the hybrid's one-step update is elementwise), each on plain,
    contiguous tensors: no DTensor reaches a wrapper."""
    outs, _ = runs
    cfg = _config(name)
    for got in _peers(outs, "serve", name, dims):
        calls = got["prefill_calls"]
        assert [n for n, _ in calls] == _kernel_calls(cfg, "prefill")
        assert all(plain for _, plain in calls), calls
        for calls in got["decode"]["calls"]:
            assert [n for n, _ in calls] == _kernel_calls(cfg, "decode")
            assert all(plain for _, plain in calls), calls


@pytest.mark.parametrize("name,dims", TRAIN, ids=_ids(TRAIN))
def test_gspmd_trains_like_reference(runs, name, dims):
    """Three steps: losses at 1e-4 / 1e-3 of the reference's, params at
    atol 1e-5 / rtol 1e-4 (at most 0.1% of a leaf off, every element
    within 3 lr: module docstring), every peer the same; params and
    moments stay
    at ``param_shardings``; no kernel wrapper is called (train mode's
    scans are the plain loops, on local blocks)."""
    outs, ref = runs
    want = ref["train"][name, dims]
    peers = _peers(outs, "train", name, dims)
    lr = RunConfig(model=_config(name), shape=ShapeConfig(
        "t", "train", TRAIN_S, B)).lr
    for got in peers:
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


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_one_by_one_mesh_equals_plain_steps(group, name):
    """On a (1, 1) mesh the DTensor prefill, decode and train steps
    equal ``api.prefill``, ``api.decode_step``
    and the plain one-peer step bit for bit: logits, every state leaf,
    the loss and every param."""
    cfg = _config(name)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", "decode", S + STEPS,
                                                 B),
                    comm=CommConfig(mode="gspmd"))
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    pre, dec = _inputs(cfg.vocab_size)
    as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu")
    place = lambda t: sharding.distribute_tree(
        t, sharding.batch_sharding(mesh, t))
    dparams = sharding.distribute_tree(params, sharding.param_shardings(
        mesh, api.specs(cfg)))
    same = lambda a, b: all(torch.equal(x.full_tensor(), y) for (_, x), (
        _, y) in zip(tree_paths(a), tree_paths(b)))
    lp, cp = api.prefill(params, as_t(pre), cfg)
    lm, cm = steps.make_prefill_step(run, mesh)(dparams, place(as_t(pre)))
    assert torch.equal(lm.full_tensor(), lp) and same(cm, cp)
    decode = steps.make_decode_step(run, mesh)
    csh = sharding.cache_shardings(mesh, cp)
    placed = sharding.distribute_tree(cp, csh)
    plain = cp
    for d in dec:
        l1, plain = api.decode_step(params, plain, as_t(d), cfg)
        l2, placed = decode(dparams, placed, place(as_t(d)))
        assert torch.equal(l2.full_tensor(), l1)
    assert same(placed, plain)
    trun = RunConfig(model=cfg, shape=ShapeConfig("t", "train", TRAIN_S, B),
                     comm=CommConfig(mode="gspmd"), warmup_steps=1,
                     total_steps=2)
    state = steps.init_train_state(torch.Generator().manual_seed(0), trun,
                                   "cpu")
    placed = steps.distribute_state(state, steps.train_state_shardings(
        mesh, trun))
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        batch = {k: torch.randint(0, cfg.vocab_size, (B, TRAIN_S),
                                  generator=gen)
                 for k in ("tokens", "labels")}
        state, want = steps.make_train_step_gspmd(trun)(state, batch)
        placed, got = steps.make_train_step_gspmd(trun, mesh)(placed, batch)
        assert torch.equal(got["loss"], want["loss"])
    assert same(placed.params, state.params)


def test_scan_wrappers_refuse_dtensors(group):
    """``ops.wkv6`` and ``ops.rglru`` take plain tensors: a DTensor (here
    on a one-rank mesh) raises a TypeError naming the ``local_map``
    helper that runs them on local blocks."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu")
    dt = lambda *shape: DTensor.from_local(torch.rand(shape), mesh,
                                           [Replicate()] * 2)
    with pytest.raises(TypeError, match="rwkv6.scan_blocks"):
        ops.wkv6(dt(1, 3, 2, 4), dt(1, 3, 2, 4), dt(1, 3, 2, 4),
                 dt(1, 3, 2, 4), dt(2, 4), dt(1, 2, 4, 4))
    with pytest.raises(TypeError, match="hybrid.scan_blocks"):
        ops.rglru(dt(1, 3, 8), dt(1, 3, 8), dt(1, 8))
