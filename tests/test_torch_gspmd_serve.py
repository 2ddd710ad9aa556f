"""repro_torch's GSPMD serve steps on DTensor against the JAX reference's
``make_prefill_step`` / ``make_decode_step`` (jitted with ``serve_specs``'
shardings: params at ``param_shardings``, inputs at ``batch_sharding``,
the cache at ``cache_shardings`` in and out):

* MESHES — gloo peers over ``(2, 1)``, ``(1, 2)``, ``(2, 2)``
  ``("data", "model")`` and ``(2, 2, 1)`` ``("pod", "data", "model")``
  serve one prefill (per-row ``last_pos``) and three decode steps, once
  with a 0-d ``pos`` and once with a ``(B,)`` one, beside the reference
  on 4 host devices with the same mesh shapes (a JAX subprocess, run
  beside them). Three configs: ``qwen2-0.5b-reduced`` (4 heads, 2 KV
  heads: both divide the ``model`` axis) at B=4 on every mesh; the
  same model with 6 heads and 3 KV heads at B=3 on the meshes with
  ``model`` = 2 (the query heads split, the KV heads do not, so each
  peer's flash call reads the KV heads of its own query heads in global
  numbering; the batch does not split over ``data``); and
  ``llava-next-mistral-7b-reduced`` (the patch prefix, its ``pos``
  offset) at B=4 on ``(2, 2)``. Logits and caches are held at the
  port's JAX-parity tolerances (atol = rtol = 1e-4 on f32). After every
  decode step the cache is the object the step was given, at its
  ``cache_shardings`` placements; its values after three steps are the
  reference's. Every prefill runs the flash wrapper once per layer on
  plain, contiguous local blocks.
* ONE PEER — a ``(1, 1)`` mesh's serve steps equal ``api.prefill`` and
  ``api.decode_step`` on plain tensors bit for bit; ``mesh=None`` is the
  plain step; every other family (moe, ssm, hybrid, encdec) builds its
  steps over a mesh (their gloo runs: ``test_torch_gspmd_recurrent.py``,
  ``test_torch_gspmd_moe_encdec.py``).
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
from repro_torch.launch.mesh import make_abstract_mesh, make_device_mesh
from repro_torch.models import api
from repro_torch.models.common import tree_map

try:
    import jax
    from repro.configs.registry import get_config as jax_config
    from repro.models import api as japi
except ImportError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, MAX, STEPS = 12, 24, 3
TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = {(2, 1): ("data", "model"), (1, 2): ("data", "model"),
          (2, 2): ("data", "model"), (2, 2, 1): ("pod", "data", "model")}
# name -> (arch, config fields replaced, batch, meshes)
CONFIGS = {
    "dense": ("qwen2-0.5b-reduced", {}, 4, tuple(MESHES)),
    "heads_split": ("qwen2-0.5b-reduced", {"num_heads": 6,
                                           "num_kv_heads": 3}, 3,
                    ((1, 2), (2, 2))),
    "vlm": ("llava-next-mistral-7b-reduced", {}, 4, ((2, 2),)),
}
CASES = [(name, dims) for name, c in CONFIGS.items() for dims in c[3]]

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
    from repro_torch.models.convert import from_numpy_params

    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    with open(inp, "rb") as f:
        data = pickle.load(f)
    calls = []
    flash = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(all(type(t) is torch.Tensor and t.is_contiguous()
                         for t in (q, k, v)))
        return flash(q, k, v, **kw)

    ops.flash_attention = counted
    full = lambda t: t.full_tensor().numpy()
    res = {}
    try:
        for (name, dims), axes in data["runs"][world]:
            arch, repl, b, _ = data["configs"][name]
            cfg = dataclasses.replace(get_config(arch), **repl)
            run = RunConfig(model=cfg, shape=ShapeConfig(
                "s", "decode", data["max"], b), comm=CommConfig(mode="gspmd"))
            mesh = make_device_mesh(dims, axes, "cpu")
            params = from_numpy_params(data["params"][name], "cpu")
            params = sharding.distribute_tree(params, sharding.param_shardings(
                mesh, api.specs(cfg)))
            place = lambda t: sharding.distribute_tree(
                t, sharding.batch_sharding(mesh, t))
            pre = {k: torch.as_tensor(v) for k, v in
                   data["prefill"][name].items()}
            del calls[:]
            logits, cache = steps.make_prefill_step(run, mesh)(params,
                                                               place(pre))
            got = {"prefill": full(logits), "flash": list(calls),
                   "prefill_cache": {k: full(v) for k, v in cache.items()}}
            grown = api.grow_cache(cfg, {k: v.full_tensor() for k, v in
                                         cache.items()}, data["max"])
            csh = sharding.cache_shardings(mesh, grown)
            decode = steps.make_decode_step(run, mesh)
            for form, decs in data["decode"][name].items():
                c = sharding.distribute_tree(grown, csh)
                outs, kept = [], []
                for dec in decs:
                    lg, c2 = decode(params, c, place(
                        {k: torch.as_tensor(v) for k, v in dec.items()}))
                    outs.append(full(lg))
                    kept.append(c2 is c and all(
                        isinstance(c[k], DTensor) and tuple(c[k].placements)
                        == tuple(csh[k].placements) for k in c))
                got[form] = {"logits": outs, "kept": kept,
                             "cache": {k: full(v) for k, v in c.items()}}
            res[name, dims] = got
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

    inp, out = sys.argv[1:]
    with open(inp, "rb") as f:
        data = pickle.load(f)
    i32 = lambda t: {k: np.asarray(v, np.int32) if v.dtype == np.int64
                     else v for k, v in t.items()}
    res = {}
    for (name, dims), axes in data["runs"][2] + data["runs"][4]:
        arch, repl, b, _ = data["configs"][name]
        cfg = dataclasses.replace(get_config(arch), **repl)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", "decode",
                                                     data["max"], b),
                        comm=CommConfig(mode="gspmd"))
        mesh = jax.make_mesh(
            dims, axes, axis_types=(compat.AxisType.Auto,) * len(axes),
            devices=jax.devices()[:math.prod(dims)])
        with compat.set_mesh(mesh):
            psh = param_shardings(mesh, api.specs(cfg), fsdp=True)
            params = jax.device_put(jax.tree.map(jnp.asarray,
                                                 data["params"][name]), psh)
            pre = i32(data["prefill"][name])
            logits, cache = jax.jit(steps.make_prefill_step(run, mesh),
                                    in_shardings=(psh, batch_sharding(
                                        mesh, pre)))(params, pre)
            got = {"prefill": np.asarray(logits), "prefill_cache": {
                k: np.asarray(v) for k, v in cache.items()}}
            grown = api.grow_cache(cfg, cache, data["max"])
            csh = cache_shardings(mesh, grown)
            for form, decs in data["decode"][name].items():
                dec_fn = jax.jit(steps.make_decode_step(run, mesh),
                                 in_shardings=(psh, csh, batch_sharding(
                                     mesh, i32(decs[0]))),
                                 out_shardings=(None, csh))
                c = jax.device_put(grown, csh)
                outs = []
                for dec in decs:
                    lg, c = dec_fn(params, c, i32(dec))
                    outs.append(np.asarray(lg))
                got[form] = {"logits": outs,
                             "cache": {k: np.asarray(v) for k, v in c.items()}}
        res[name, dims] = got
    with open(out, "wb") as f:
        pickle.dump(res, f)
''')


def _config(name):
    arch, repl, _, _ = CONFIGS[name]
    return dataclasses.replace(get_config(arch), **repl)


def _inputs(name, vocab: int, d_model: int, patches: int) -> tuple:
    """One prefill batch (per-row prompt ends) and each decode form's
    three batches: a 0-d ``pos`` after the padded prompt, and a ``(B,)``
    one after each row's own end."""
    b = CONFIGS[name][2]
    rng = np.random.default_rng(7)
    last = np.array([S - 1 - (i % 4) for i in range(b)])
    pre = {"tokens": rng.integers(0, vocab, (b, S)), "last_pos": last}
    if patches:
        pre["patches"] = rng.normal(size=(b, patches, d_model)).astype(
            np.float32)
    tok = lambda: rng.integers(0, vocab, (b,))
    dec = {"scalar": [{"token": tok(), "pos": np.array(S + i)}
                      for i in range(STEPS)],
           "rows": [{"token": tok(), "pos": last + 1 + i}
                    for i in range(STEPS)]}
    return pre, dec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Gloo worlds of 2 and 4 peers over every (config, mesh) case, and
    the reference on 4 host devices, all started together."""
    if jax is None:
        pytest.skip("the JAX reference is not installed")
    tmp = tmp_path_factory.mktemp("gspmd_serve")
    params, pre, dec = {}, {}, {}
    for name, (arch, repl, _, _) in CONFIGS.items():
        jcfg = dataclasses.replace(jax_config(arch), **repl)
        rng = np.random.default_rng(1)
        params[name] = jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(scale=0.05, size=np.shape(
                a)).astype(np.float32),
            japi.init(jax.random.PRNGKey(0), jcfg))
        pre[name], dec[name] = _inputs(name, jcfg.vocab_size, jcfg.d_model,
                                       jcfg.num_patches)
    by_world = {2: [], 4: []}
    for name, dims in CASES:
        by_world[math.prod(dims)].append(((name, dims), MESHES[dims]))
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"configs": CONFIGS, "params": params, "prefill": pre,
                     "decode": dec, "runs": by_world, "max": MAX}, f)
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
    return outs, ref


def _ids(cases):
    return [f"{n}-{'x'.join(map(str, d))}" for n, d in cases]


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_serve_steps_match_reference(runs, name, dims):
    """Prefill logits and cache, then three decode steps at each ``pos``
    form: the reference's values on every peer."""
    outs, ref = runs
    world = math.prod(dims)
    want = ref[name, dims]
    for r in range(world):
        got = outs[world, r][name, dims]
        np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(got["prefill_cache"][k],
                                       want["prefill_cache"][k], **TOL)
        for form in ("scalar", "rows"):
            for i, (g, w) in enumerate(zip(got[form]["logits"],
                                           want[form]["logits"])):
                np.testing.assert_allclose(g, w, err_msg=f"{form} {i}",
                                           **TOL)


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_decode_writes_the_given_cache_at_its_shardings(runs, name, dims):
    """After every decode step the cache is the object the step was
    given, every leaf a DTensor at its ``cache_shardings`` placements,
    and after three steps it holds the reference's values."""
    outs, ref = runs
    world = math.prod(dims)
    for r in range(world):
        got = outs[world, r][name, dims]
        for form in ("scalar", "rows"):
            assert got[form]["kept"] == [True] * STEPS, form
            for k in ("k", "v"):
                np.testing.assert_allclose(
                    got[form]["cache"][k], ref[name, dims][form]["cache"][k],
                    err_msg=f"{form} {k}", **TOL)


@pytest.mark.parametrize("name,dims", CASES, ids=_ids(CASES))
def test_prefill_runs_flash_on_local_blocks(runs, name, dims):
    """The flash wrapper ran once per layer in the prefill, on plain,
    contiguous tensors (each peer's local blocks)."""
    outs, _ = runs
    for r in range(math.prod(dims)):
        calls = outs[math.prod(dims), r][name, dims]["flash"]
        assert calls == [True] * _config(name).num_layers, calls


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


@pytest.mark.parametrize("name", ["dense", "vlm"])
def test_one_by_one_mesh_equals_plain_serve(group, name):
    """On a (1, 1) mesh the DTensor prefill and decode steps equal
    ``api.prefill`` / ``api.decode_step`` on plain tensors bit for bit,
    logits and cache, at both ``pos`` forms; ``mesh=None`` gives the
    plain steps themselves."""
    cfg = _config(name)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", "decode", MAX, 4),
                    comm=CommConfig(mode="gspmd"))
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    pre, dec = _inputs(name, cfg.vocab_size, cfg.d_model, cfg.num_patches)
    as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu")
    place = lambda t: sharding.distribute_tree(
        t, sharding.batch_sharding(mesh, t))
    dparams = sharding.distribute_tree(params, sharding.param_shardings(
        mesh, api.specs(cfg)))
    lp, cp = api.prefill(params, as_t(pre), cfg)
    lm, cm = steps.make_prefill_step(run, mesh)(dparams, place(as_t(pre)))
    ln, cn = steps.make_prefill_step(run, None)(params, as_t(pre))
    assert torch.equal(lm.full_tensor(), lp) and torch.equal(ln, lp)
    for k in cp:
        assert torch.equal(cm[k].full_tensor(), cp[k]) and \
            torch.equal(cn[k], cp[k])
    grown = api.grow_cache(cfg, cp, MAX)
    decode = steps.make_decode_step(run, mesh)
    for form, decs in dec.items():
        plain = tree_map(torch.clone, grown)
        placed = sharding.distribute_tree(grown, sharding.cache_shardings(
            mesh, grown))
        for d in decs:
            l1, plain = api.decode_step(params, plain, as_t(d), cfg)
            l2, placed = decode(dparams, placed, place(as_t(d)))
            assert torch.equal(l2.full_tensor(), l1), form
        for k in plain:
            assert torch.equal(placed[k].full_tensor(), plain[k]), (form, k)


@pytest.mark.parametrize("arch", ["mixtral-8x7b-reduced",
                                  "rwkv6-7b-reduced",
                                  "recurrentgemma-9b-reduced",
                                  "whisper-tiny-reduced"])
def test_unthreaded_families_raise_in_the_serve_steps(arch):
    """No family is left unthreaded: every one (moe, ssm, hybrid and
    encdec here) builds its prefill and decode steps over a (2, 2) mesh
    as over a (1, 1) one, whatever the comm mode (their runs over gloo
    meshes: ``test_torch_gspmd_recurrent.py``,
    ``test_torch_gspmd_moe_encdec.py``)."""
    run = RunConfig(model=get_config(arch),
                    shape=ShapeConfig("s", "decode", MAX, 4),
                    comm=CommConfig(mode="hadronio"))
    two = make_abstract_mesh((2, 2), ("data", "model"))
    one = make_abstract_mesh((1, 1), ("data", "model"))
    assert run.model.family in steps.GSPMD_FAMILIES
    for make in (steps.make_prefill_step, steps.make_decode_step):
        assert callable(make(run, two)) and callable(make(run, one))


def test_serve_specs_are_the_references_layouts():
    """``serve_specs``' six-tuple: the params', cache's and inputs'
    shapes and dtypes as the reference's, and their shardings the rules'
    placements (the cache at ``cache_shardings``)."""
    cfg = get_config("qwen2-0.5b")
    run = RunConfig(model=cfg, shape=ShapeConfig("decode_32k", "decode",
                                                 32768, 128))
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    params, cache, inputs, psh, csh, ish = steps.serve_specs(
        run, run.shape, mesh)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: (24, 128, 32768, 2, 64) for k in ("k", "v")}
    assert all(v.device.type == "meta" for v in cache.values())
    assert {k: tuple(v.shape) for k, v in inputs.items()} == {
        "token": (128,), "pos": ()}
    assert csh["k"].spec == (None, "data", "model", None, None)
    assert ish["token"].spec == ("data",) and ish["pos"].spec == ()
    assert psh["embed"]["tok"].spec == sharding.spec_partition(
        mesh, api.specs(cfg)["embed"]["tok"])
    assert params["embed"]["tok"].shape == (cfg.vocab_size, cfg.d_model)
