"""repro_torch's ZeRO-1 and bucketed modes (``hadronio_rs``,
``hadronio_overlap``, ``hadronio_overlap_rs``) against the JAX
reference, on the CPU.

* Plans and masks: the bucket plans, alignments and epilogue groups are
  integers and must equal the reference's, at full width and reduced;
  the decay masks (and each peer's shard of them) are compared bitwise
  on the reduced config (a full-width mask is 2 GB).
* Pure functions: ``flat_adamw_update`` on seeded inputs, the reshard
  rules (power-of-two and odd scatter groups) exactly.
* Three TAC steps at ring size 1 against the reference's step on a
  one-device mesh, started from the same state
  (``convert.from_numpy_train_state``), at ``test_torch_train.py``'s
  tolerances; the flat moments are compared as flat vectors, each
  element against the largest magnitude of its own leaf.
* A 4-peer gloo ring (subprocesses): ``sync_grads`` then
  ``gathered_grads`` give 4·g for the six TAC modes at
  ``tests/distributed/check_tac_modes.py``'s bounds (1e-4; bf16 0.02
  relative; int8 0.1), and every peer's flat shard equals the
  reference's layout of the exact sum, bitwise, under every aggregate x
  flush.
* A 2-peer trajectory: three steps of the two ZeRO-1 modes stay within
  2e-3 of ``sockets``' losses (``check_steps.py``'s bound) and their
  parameters within 1e-5 of ``sockets``' (a wrong chunk of a
  parameter or mask still trains, so the loss alone cannot show it).
"""
import dataclasses
import itertools
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
from repro_torch.core import aggregation as agg
from repro_torch.core.backends import (SyncContext, available_modes,
                                       get_backend, pipeline,
                                       scatter_group_size)
from repro_torch.core.backends import hadronio_overlap as ov
from repro_torch.core.backends import hadronio_overlap_rs as ovrs
from repro_torch.core.channels import Ring
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps, train as train_cli
from repro_torch.models import api
from repro_torch.models.common import tree_paths
from repro_torch.models.convert import from_numpy_train_state
from repro_torch.optim import flat

try:
    import jax
    import jax.numpy as jnp
    from repro import compat as jcompat
    from repro.configs.base import CommConfig as JCommConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.core import aggregation as jagg
    from repro.core.backends import available_modes as jax_modes
    from repro.core.backends import get_backend as jax_backend
    from repro.core.backends import hadronio_overlap as jov
    from repro.core.backends import hadronio_overlap_rs as jovrs
    from repro.core.backends import pipeline as jpipeline
    from repro.data import pipeline as jdata
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
    from repro.models import api as japi
    from repro.optim import flat as jflat
except ImportError:
    jax = None

ARCH = "qwen2-0.5b-reduced"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 24
ZERO1 = ("hadronio_rs", "hadronio_overlap_rs")
NEW = ("hadronio_rs", "hadronio_overlap", "hadronio_overlap_rs")


@pytest.fixture(scope="module")
def jx():
    if jax is None:
        pytest.skip("the JAX reference is not installed")


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


# -- plans and masks ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", ARCH])
@pytest.mark.parametrize("slice_bytes", [4 * 1024 * 1024, 64 * 1024, 1000])
def test_bucket_plans_match_jax(jx, arch, slice_bytes):
    jtree = japi.abstract(jax_config(arch))
    specs = api.specs(get_config(arch))
    for channels, aggregate, flush_ in itertools.product(
            (1, 3, 4), ("slice", "channel"), ("step", "ready")):
        kw = dict(slice_bytes=slice_bytes, channels=channels,
                  aggregate=aggregate, flush=flush_)
        comm, jcomm = CommConfig(**kw), JCommConfig(**kw)
        assert tuple(ov.make_bucket_plan(specs, comm)) == \
            tuple(jov.make_bucket_plan(jtree, jcomm))
        for group in (1, 2, 3, 4):
            assert ovrs.rs_align(group) == jovrs.rs_align(group)
            plan = ovrs.rs_bucket_plan(specs, comm, group)
            assert tuple(plan) == tuple(jovrs.rs_bucket_plan(jtree, jcomm,
                                                             group))
            assert ovrs.gather_flush_groups(plan, comm) == \
                jovrs.gather_flush_groups(plan, jcomm)
    if (arch, slice_bytes) == ("qwen2-0.5b", 4 * 1024 * 1024):
        # the card's run: 11 buckets, 4 ready flushes over 4 channels
        comm = CommConfig(slice_bytes=slice_bytes, channels=4,
                          aggregate="channel", flush="ready")
        plan = ovrs.rs_bucket_plan(specs, comm, 1)
        assert plan.n_buckets == 11 and max(plan.padded) == 136_134_656
        assert len(ovrs.gather_flush_groups(plan, comm)) == 4


@pytest.mark.parametrize("slice_bytes", [64 * 1024, 1000])
def test_decay_masks_and_their_shards_match_jax(jx, slice_bytes):
    """Bitwise: the flat and bucketed decay masks, and each peer's shard
    of them in the reference's layouts (``reshape(n_slices, group,
    -1)[:, my]`` and ``shard_of_buckets``), for rings of 1-4 peers."""
    jtree = japi.abstract(jax_config(ARCH))
    specs = api.specs(get_config(ARCH))
    comm = CommConfig(slice_bytes=slice_bytes)
    jcomm = JCommConfig(slice_bytes=slice_bytes)
    plan, jplan = agg.make_plan(specs, comm), jagg.make_plan(jtree, jcomm)
    want = np.asarray(jflat.decay_mask_traced(jplan))
    np.testing.assert_array_equal(flat.decay_mask_flat(plan),
                                  jflat.decay_mask_flat(jplan))
    np.testing.assert_array_equal(flat.decay_mask(plan, "cpu").numpy(), want)
    for group in (1, 2, 3, 4):
        # a ring slice shards over powers of two only (512-aligned)
        for my in range(group if plan.slice_elems % group == 0 else 0):
            shard = flat.mask_from_runs(flat.shard_runs(
                flat.decay_runs(plan), [plan.slice_elems] * plan.n_slices,
                group, my), plan.padded_elems // group, "cpu")
            np.testing.assert_array_equal(shard.numpy(), want.reshape(
                plan.n_slices, group, -1)[:, my].reshape(-1))
        bplan = ovrs.rs_bucket_plan(specs, comm, group)
        jmask = np.asarray(jovrs.bucket_decay_mask(bplan))
        np.testing.assert_array_equal(
            ovrs.bucket_decay_mask(bplan, "cpu").numpy(), jmask)
        starts = np.cumsum((0,) + bplan.padded)
        for my in range(group):
            want_b = np.asarray(jovrs.shard_of_buckets(
                [jmask[starts[b]:starts[b + 1]]
                 for b in range(bplan.n_buckets)], bplan, group, my))
            shard = flat.mask_from_runs(flat.shard_runs(
                ovrs.bucket_decay_runs(bplan), bplan.padded, group, my),
                bplan.total_padded // group, "cpu")
            np.testing.assert_array_equal(shard.numpy(), want_b)


def test_modes_and_scatter_group(jx):
    assert available_modes() == jax_modes()
    assert [get_backend(m).zero1 for m in available_modes()] == \
        [jax_backend(m).zero1 for m in jax_modes()]
    assert scatter_group_size(4, 1, CommConfig()) == 4
    with pytest.raises(NotImplementedError, match="item 8"):
        scatter_group_size(8, 2, CommConfig())


# -- pure functions ----------------------------------------------------------


@pytest.mark.parametrize("count", [1, 2, 7])
def test_flat_adamw_update_matches_jax(jx, count):
    rng = np.random.default_rng(count)
    n = 4099
    p, g = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    mu = (rng.normal(size=n) * 1e-2).astype(np.float32)
    nu = np.abs(rng.normal(size=n) * 1e-4).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    kw = dict(warmup_steps=3, total_steps=10, weight_decay=0.1)
    jrun = JRunConfig(model=jax_config(ARCH), shape=JShapeConfig(
        "t", "train", S, B), **kw)
    trun = RunConfig(model=get_config(ARCH), shape=ShapeConfig(
        "t", "train", S, B), **kw)
    want = jax.jit(lambda *a: jflat.flat_adamw_update(*a, jrun))(
        p, g, mu, nu, jnp.int32(count), mask)
    got = flat.flat_adamw_update(*map(torch.from_numpy, (p, g, mu, nu)),
                                 count, torch.from_numpy(mask), trun)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("old,new,modes", [
    (4, 2, ZERO1), (2, 4, ZERO1), (4, 1, ZERO1),
    (4, 3, ("hadronio_overlap_rs",)), (3, 6, ("hadronio_overlap_rs",))])
def test_reshard_rules_match_jax(jx, old, new, modes):
    """Both backends' rules and the segment re-slice, exactly: powers of
    two re-slice; a change of lcm(512, group) (4 -> 3: 512 -> 1536)
    re-plans ``hadronio_overlap_rs`` and zeroes its moments, an odd
    group that keeps it (3 -> 6) re-slices."""
    kw = dict(slice_bytes=64 * 1024)
    jrun = JRunConfig(model=jax_config(ARCH), shape=JShapeConfig(
        "t", "train", S, B), comm=JCommConfig(hierarchical=False, **kw))
    trun = RunConfig(model=get_config(ARCH), shape=ShapeConfig(
        "t", "train", S, B), comm=CommConfig(**kw))
    rng = np.random.default_rng(old * 10 + new)
    for mode in modes:
        length = int(jsteps.abstract_tac_state(
            dataclasses.replace(jrun, comm=dataclasses.replace(
                jrun.comm, mode=mode)), old).opt.mu.shape[1])
        stacked = rng.normal(size=(old, length)).astype(np.float32)
        want = jax_backend(mode).reshard_flat_shards(jrun, stacked, new)
        got = get_backend(mode).reshard_flat_shards(trun, stacked, new)
        np.testing.assert_array_equal(got, want)
        assert got.any() == (ovrs.rs_align(old) == ovrs.rs_align(new))
    segs = [1536, 3072, 512 * 3]
    stacked = rng.normal(size=(old, sum(segs) // old)).astype(np.float32)
    if all(L % old == 0 and L % new == 0 for L in segs):
        np.testing.assert_array_equal(
            flat.reshard_ring_segments(stacked, old, new, segs),
            jflat.reshard_ring_segments(stacked, old, new, segs))


def test_interleave_for_scatter_matches_jax(jx):
    rng = np.random.default_rng(0)
    flats = [rng.normal(size=n).astype(np.float32) for n in (8, 16, 4)]
    for group in (1, 2, 4):
        np.testing.assert_array_equal(
            pipeline.interleave_for_scatter(
                [torch.from_numpy(f) for f in flats], group).numpy(),
            np.asarray(jpipeline.interleave_for_scatter(
                [jnp.asarray(f) for f in flats], group)))


# -- the staged reduce-scatter and the per-flush unpack ----------------------


@pytest.mark.parametrize("aggregate,flush_", list(itertools.product(
    CommConfig.AGGREGATES, CommConfig.FLUSHES)))
def test_bucket_stage_packs_per_bucket_and_unpacks_per_flush(
        ring, monkeypatch, aggregate, flush_):
    """One pack stage per bucket; one unpack per flush: per bucket under
    ``slice``, per channel under ``channel``; the f32 results equal the
    packed buckets (at ring size 1 a sum and a scatter are copies)."""
    calls = {"pack_slices": 0, "unpack_slices": 0}
    for name in calls:
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _fn(*a, **k))[1])
    specs = api.specs(get_config(ARCH))
    params = api.init(torch.Generator().manual_seed(0), get_config(ARCH),
                      device="cpu")
    grads = {p: t.float() for p, t in tree_paths(params)}
    leaves = list(grads.values())
    comm = CommConfig(mode="hadronio_overlap_rs", compress="bf16",
                      pack="pallas", slice_bytes=64 * 1024, channels=4,
                      aggregate=aggregate, flush=flush_)
    plan = ovrs.rs_bucket_plan(specs, comm, 1)
    for kind in ("all_reduce", "reduce_scatter"):
        calls.update(pack_slices=0, unpack_slices=0)
        ctx = SyncContext(comm, ring=ring)
        outs, new_efs = ov.stage_buckets(leaves, plan, ctx, kind, group=1)
        flushes = plan.n_buckets if aggregate == "slice" else 4
        assert calls == {"pack_slices": plan.n_buckets,
                         "unpack_slices": flushes}, (kind, calls)
        for b, out in enumerate(outs):
            want = ov.pack_bucket(leaves, plan, b)
            wire = (want + torch.zeros_like(want)).to(torch.bfloat16)
            assert out.dtype == torch.float32
            assert torch.equal(out.reshape(-1), wire.float())
            assert torch.equal(new_efs[b], want - wire.float())


# -- three TAC steps at ring size 1 ------------------------------------------


def _batch(step, vocab):
    return jdata.batch_at(jdata.SyntheticSource(vocab, 0),
                          jdata.DataConfig(S, B), step)


def _tbatch(b):
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _leaf_ranges(mode, jrun):
    """Per leaf, its (start, end) in the flat ZeRO-1 vector at ring size
    1, from the reference's own plans."""
    tree = japi.abstract(jrun.model)
    if mode == "hadronio_rs":
        return list(jagg.make_plan(tree, jrun.comm).offsets)
    plan = jovrs.rs_bucket_plan(tree, jrun.comm, 1)
    out, base = [None] * len(plan.sizes), 0
    for b, idx in enumerate(plan.buckets):
        off = base
        for i in idx:
            out[i] = (off, off + plan.sizes[i])
            off += plan.sizes[i]
        base += plan.padded[b]
    return out


def _moments_close(got, want, ranges=None):
    """Per leaf at rtol 2^-7 and an atol of 1e-3 of the leaf's largest
    magnitude; flat vectors element by element against their leaf's."""
    if ranges is None:
        pairs = [(g, w) for (_, g), (_, w) in zip(tree_paths(got),
                                                  tree_paths(want))]
    else:
        assert got.shape == want.shape
        pairs = [(got[s:e], want[s:e]) for s, e in ranges]
        pad = torch.ones(want.numel(), dtype=torch.bool)
        for s, e in ranges:
            pad[s:e] = False
        assert not got[pad].any() and not want[pad].any()
    for g, w in pairs:
        scale = float(w.abs().max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2 ** -7,
                                   atol=1e-3 * scale)


@pytest.mark.parametrize("mode,compress,aggregate,flush_", [
    ("hadronio_rs", "bf16", "slice", "step"),
    ("hadronio_rs", "none", "channel", "ready"),
    ("hadronio_overlap", "bf16", "slice", "step"),
    ("hadronio_overlap_rs", "bf16", "channel", "ready")])
def test_three_tac_steps_match_jax(jx, ring, mode, compress, aggregate,
                                   flush_):
    comm = dict(mode=mode, compress=compress, pack="pallas",
                slice_bytes=64 * 1024, channels=4, aggregate=aggregate,
                flush=flush_)
    jrun = JRunConfig(model=jax_config(ARCH),
                      shape=JShapeConfig("t", "train", S, B),
                      comm=JCommConfig(hierarchical=False, **comm),
                      warmup_steps=1, total_steps=3)
    trun = RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", S, B),
                     comm=CommConfig(**comm), warmup_steps=1, total_steps=3)
    batches = [_batch(k, jrun.model.vocab_size) for k in range(3)]
    mesh = make_mesh((1,), ("data",))
    with jcompat.set_mesh(mesh):
        step_fn, _, _ = jsteps.make_train_step(jrun, mesh)
        jstate = jsteps.init_tac_state(jax.random.PRNGKey(0), jrun, 1)
        start = jax.tree.map(np.asarray, jstate)
        f = jax.jit(step_fn)
        jlosses = []
        for b in batches:
            jstate, m = f(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            jlosses.append(float(m["loss"]))
    jend = jax.tree.map(np.asarray, jstate)

    state = from_numpy_train_state(start, "cpu")
    specs = get_backend(mode).state_specs(trun, 1)
    if get_backend(mode).zero1:
        assert state.opt.mu.shape == specs.opt.mu.shape == \
            start.opt.mu.shape[1:]
    if compress == "bf16" and mode != "hadronio_rs":
        assert isinstance(state.ef, tuple)
        assert [e.shape for e in state.ef] == [e.shape for e in specs.ef]
    step = steps.make_train_step(trun, ring)
    losses = []
    for b in batches:
        state, m = step(state, _tbatch(b))
        losses.append(float(m["loss"]))

    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-4)
    want = from_numpy_train_state(jend, "cpu")
    assert state.step == 3 and state.opt.count == 3
    for (path, got), (_, ref) in zip(tree_paths(state.params),
                                     tree_paths(want.params)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=path)
    ranges = _leaf_ranges(mode, jrun) if get_backend(mode).zero1 else None
    _moments_close(state.opt.mu, want.opt.mu, ranges)
    _moments_close(state.opt.nu, want.opt.nu, ranges)
    if compress == "none":
        assert state.ef is None and want.ef is None
        return
    cat = lambda e: torch.cat([x.reshape(-1) for x in e]) \
        if isinstance(e, tuple) else e.reshape(-1)
    got_ef, want_ef = cat(state.ef), cat(want.ef)
    ef_scale = float(want_ef.abs().max())
    assert ef_scale > 0
    diff = (got_ef - want_ef).abs()
    assert float((diff > 1e-3 * ef_scale).float().mean()) < 0.01
    assert float(diff.max()) <= 4 * ef_scale


@pytest.mark.parametrize("mode", NEW)
def test_cli_trains_and_serves(mode, capsys):
    assert train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps",
                           "2", "--global-batch", "2", "--seq-len", "16",
                           "--mode", mode, "--compress", "bf16", "--pack",
                           "pallas"]) == 0
    assert serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "3", "--max-new", "2", "--batch", "2",
                           "--comm-mode", mode, "--aggregate",
                           "channel"]) == 0
    out = capsys.readouterr().out
    assert "[trainer] step 1 loss" in out and "final loss:" in out
    assert f"comm={mode}" in out and "[serve] 3 requests, 6 tokens" in out


# -- rings of 4 and 2 peers (gloo subprocesses) ------------------------------

_WORKER = textwrap.dedent('''
    import itertools, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tac
    from repro_torch.core.backends import get_backend
    from repro_torch.core.channels import Ring
    from repro_torch.data import pipeline as data
    from repro_torch.launch import steps
    from repro_torch.models.common import tree_map, tree_paths

    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        ring = Ring(channels=4)
        with open(inp, "rb") as f:
            data_in = pickle.load(f)
        res = {}
        fresh = lambda tree: tree_map(lambda a: torch.tensor(a), tree)
        flat = lambda tree: np.concatenate(
            [t.numpy().ravel() for _, t in tree_paths(tree)])
        if world == 4:
            kw = dict(slice_bytes=1024, ring_capacity_bytes=64 * 1024)
            for mode, comp, pack in data_in["combos"]:
                comm = CommConfig(mode=mode, compress=comp, pack=pack, **kw)
                g = fresh(data_in["grads"])
                r = tac.sync_grads(g, comm, ring=ring)
                res["gathered", mode, comp, pack] = flat(
                    get_backend(mode).gathered_grads(r, g))
            # 2 channels for 3 slices or buckets: a channel flush
            # coalesces two of them
            for mode, agg_, fl in itertools.product(
                    ("hadronio_rs", "hadronio_overlap_rs"),
                    ("slice", "channel"), ("step", "ready")):
                comm = CommConfig(mode=mode, aggregate=agg_, flush=fl,
                                  channels=2, **kw)
                r = tac.sync_grads(fresh(data_in["exact"][rank]), comm,
                                   ring=ring)
                res["shard", mode, agg_, fl] = r.flat_shard.numpy()
        else:
            cfg = get_config("qwen2-0.5b-reduced")
            for mode in ("sockets", "hadronio_rs", "hadronio_overlap_rs"):
                run = RunConfig(model=cfg,
                                shape=ShapeConfig("t", "train", 16, 4),
                                comm=CommConfig(mode=mode,
                                                slice_bytes=64 * 1024,
                                                aggregate="channel",
                                                flush="ready"),
                                warmup_steps=1, total_steps=3)
                state = steps.init_tac_state(
                    torch.Generator().manual_seed(0), run, "cpu",
                    n_shards=world)
                step = steps.make_train_step(run, ring)
                src = data.SyntheticSource(cfg.vocab_size, 0)
                dc = data.DataConfig(16, 4, host_index=rank,
                                     num_hosts=world)
                losses = []
                for k in range(3):
                    b = {n: torch.as_tensor(v).long() for n, v in
                         data.batch_at(src, dc, k).items()}
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
                res["losses", mode] = losses
                res["params", mode] = flat(state.params)
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')


def _ring_run(tmp_path, world, data_in):
    inp = tmp_path / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data_in, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / "store"), str(inp), str(tmp_path / f"out{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _tree(seed, exact=False):
    """check_tac_modes.py's gradient tree; ``exact``: multiples of 1/8
    below 16, so that any sum of four of them is exact in f32."""
    rng = np.random.default_rng(seed)
    draw = (lambda *s: (rng.integers(-127, 128, s) / 8).astype(np.float32)) \
        if exact else (lambda *s: rng.normal(size=s).astype(np.float32))
    return {"a": draw(33, 7), "b": {"c": draw(129), "d": draw(2, 3, 5)},
            "e": draw(1024)}


def _flat(tree):
    return np.concatenate([np.asarray(t).ravel() for _, t in
                           tree_paths(tree)])


def test_ring_of_four_peers(jx, tmp_path):
    combos = [(m, "none", "jnp") for m in ("sockets", "vma", "hadronio",
                                           "hadronio_overlap", *ZERO1)]
    combos += [(m, c, p) for m in ("hadronio", "hadronio_overlap", *ZERO1)
               for c, p in (("bf16", "jnp"), ("bf16", "pallas"),
                            ("int8_ef", "jnp"))]
    grads = _tree(0)
    exact = [_tree(10 + r, exact=True) for r in range(4)]
    outs = _ring_run(tmp_path, 4, {"combos": combos, "grads": grads,
                                   "exact": exact})
    want = 4.0 * _flat(grads)
    for mode, comp, pack in combos:
        for r, o in enumerate(outs):
            got = o["gathered", mode, comp, pack]
            if comp == "bf16":
                err = np.max(np.abs(got - want) / (np.abs(want) + 1e-3))
                assert err < 0.02, (mode, pack, r, err)
            else:
                err = np.max(np.abs(got - want))
                assert err < (0.1 if comp == "int8_ef" else 1e-4), \
                    (mode, comp, r, err)
    # each peer's shard: the reference's layout of the exact sum
    jtree = jax.tree.map(jnp.asarray, exact[0])
    kw = dict(slice_bytes=1024, ring_capacity_bytes=64 * 1024)
    total = jax.tree.map(lambda *a: sum(np.asarray(x) for x in a), *exact)
    plan = jagg.make_plan(jtree, JCommConfig(**kw))
    packed = np.asarray(jagg.pack(jax.tree.map(jnp.asarray, total), plan))
    bplan = jovrs.rs_bucket_plan(jtree, JCommConfig(**kw), 4)
    assert plan.n_slices == bplan.n_buckets == 3      # over 2 channels
    leaves = jax.tree.leaves(jax.tree.map(jnp.asarray, total))
    buckets = [jov.pack_bucket(leaves, bplan, b)
               for b in range(bplan.n_buckets)]
    for r, o in enumerate(outs):
        layouts = {
            "hadronio_rs": packed.reshape(plan.n_slices, 4, -1)[:, r]
            .reshape(-1),
            "hadronio_overlap_rs": np.asarray(jovrs.shard_of_buckets(
                buckets, bplan, 4, r))}
        for key, got in o.items():
            if key[0] == "shard":
                np.testing.assert_array_equal(got, layouts[key[1]],
                                              err_msg=str((r, key)))


def test_ring_of_two_peers_trajectory(tmp_path):
    """Three steps on two peers with the same start state and batches:
    the ZeRO-1 modes' losses within 2e-3 of ``sockets``' and their
    parameters within 1e-5 (the updates differ only in the order of the
    gradient-norm sum); both peers agree exactly."""
    outs = _ring_run(tmp_path, 2, {})
    for key, v in outs[0].items():
        np.testing.assert_array_equal(outs[1][key], v)
    ref = outs[0]["losses", "sockets"]
    assert ref[-1] < ref[0]
    for mode in ZERO1:
        np.testing.assert_allclose(outs[0]["losses", mode], ref, rtol=0,
                                   atol=2e-3)
        np.testing.assert_allclose(outs[0]["params", mode],
                                   outs[0]["params", "sockets"], rtol=0,
                                   atol=1e-5)
