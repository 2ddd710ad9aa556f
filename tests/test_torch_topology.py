"""repro_torch's two-level pod fabric against the JAX reference, case for
case with ``tests/test_topology.py``, ``tests/distributed/check_topology.py``
and ``tests/test_obs.py``'s leader-flush nesting:

* UNITS — ``CommConfig``/``ServeConfig``'s pod checks and the ring's
  divisibility error give the reference's messages; the leader split,
  ``channel_affinity``'s topology grid, ``make_leader_plan``,
  ``pod_aligned_groups`` and ``reshard_affinity``'s topology form equal
  the reference's on the same inputs.
* THE (1, 1) POD RING in this process (a one-peer gloo group): every
  serving kind through ``emit_flat``'s leader emission equals its input
  under both flush schedules, with the split kinds in order on the
  collective hook and every ``leader_flush`` span inside a ``flush`` of
  its own emission; the serve step reports the pod facts and raises the
  reference's two errors; an engine group's tokens equal the reference's,
  and the chaos flush fault and alloc hook recover on the pod ring.
* RINGS OF 2 PODS x 2 PEERS (gloo subprocesses, the subprocess pattern of
  ``tests/test_torch_serve_wire.py``), beside the reference on 4 host
  devices in a JAX subprocess: ``psum_hierarchical`` against the flat sum
  (rtol 1e-5) at S = 16 and 1003, gathers bitwise, flat against
  hierarchical dispatch logits (prefill bitwise, decode rtol 1e-4 / atol
  1e-5 with equal argmax) for the three hadronio modes and against the
  reference's at atol = rtol = 1e-4, engine-group tokens equal at 1 and 2
  loops, cross-pod collectives per decode emission 1, 2 and 4 from the
  collective hook, leader flushes nested, and a supervised resize on the
  pod ring.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jax_config
from repro.core.backends import pipeline as jpipeline
from repro.core.flush_scheduler import make_leader_plan as jleader_plan
from repro.core.selector import pod_aligned_groups as jpod_groups
from repro.launch import elastic as jelastic
from repro.launch.mesh import make_mesh, make_serve_mesh
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving import channel_affinity as jaffinity
from repro.serving import dispatch as jdispatch
from repro.serving import make_engine_group as jax_group
from repro_torch import obs
from repro_torch.configs.base import CommConfig, ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import channels as channels_mod
from repro_torch.core.backends import SyncContext, pipeline
from repro_torch.core.channels import Ring
from repro_torch.core.flush_scheduler import make_leader_plan
from repro_torch.core.selector import pod_aligned_groups
from repro_torch.launch import elastic
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import Request, chaos, dispatch, make_engine_group
from repro_torch.serving import channel_affinity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b-reduced"


def _raises_alike(make_port, make_ref):
    """Both raise ValueError with the same message, or both return."""
    try:
        want = make_ref()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_port()
        assert str(got.value) == str(e)
        return None
    return make_port(), want


# -- config validation -------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(pods=0), dict(pod_axis=""),
    dict(event_loops=2, leader_loops=3, comm=dict(channels=4)),
    dict(pods=2, comm=dict(channels=2, leader_channels=2)),
    dict(pods=2, event_loops=3, comm=dict(channels=4, leader_channels=2)),
    dict(pods=2, event_loops=3, comm=dict(channels=4, leader_channels=2,
                                          hierarchical=False)),
    dict(pods=2, event_loops=2, leader_loops=2,
         comm=dict(channels=6, leader_channels=2)),
])
def test_serve_config_pod_checks_match_reference(kw):
    kw = dict(kw)
    comm = kw.pop("comm", {})
    out = _raises_alike(
        lambda: ServeConfig(comm=CommConfig(**comm), **kw),
        lambda: JServeConfig(comm=JCommConfig(**comm), **kw))
    if out is not None:
        got, want = out
        assert (got.pods, got.pod_axis, got.leader_loops) == \
            (want.pods, want.pod_axis, want.leader_loops)


def test_comm_config_leader_channels_and_default():
    _raises_alike(lambda: CommConfig(leader_channels=0),
                  lambda: JCommConfig(leader_channels=0))
    assert (CommConfig().hierarchical, CommConfig().leader_channels) == \
        (JCommConfig().hierarchical, JCommConfig().leader_channels)


# -- leader-lane carving, affinity, plans ------------------------------------


def _ctxs(channels, leader_channels, aggregate="channel", pod="pod"):
    return [types.SimpleNamespace(pod_axis=pod, comm=C(
        channels=channels, leader_channels=leader_channels,
        aggregate=aggregate)) for C in (CommConfig, JCommConfig)]


@pytest.mark.parametrize("channels", [2, 3, 4, 6])
def test_leader_emission_and_split_match_reference(channels):
    for lc in range(1, channels + 2):
        for agg in ("slice", "channel"):
            for pod in ("pod", None):
                ctx, jctx = _ctxs(channels, lc, agg, pod)
                for size in range(1, channels + 1):
                    assert pipeline.leader_emission(ctx, size) == \
                        jpipeline.leader_emission(jctx, size)
        ctx, jctx = _ctxs(channels, lc)
        for lo in range(channels):
            for hi in range(lo + 2, channels + 1):
                idx = tuple(range(lo, hi))
                assert pipeline._leader_split(ctx, idx) == \
                    jpipeline._leader_split(jctx, idx)


@pytest.mark.parametrize("n_channels", [2, 4, 6, 8])
def test_channel_affinity_topology_grid(n_channels):
    for n_loops in range(1, n_channels + 1):
        for leaders in range(0, n_channels):
            for n_pods in (1, 2, 3):
                for leader_loops in range(0, n_loops + 2):
                    kw = dict(n_pods=n_pods, leaders=leaders,
                              leader_loops=leader_loops)
                    _raises_alike(
                        lambda: channel_affinity(n_channels, n_loops, **kw),
                        lambda: jaffinity(n_channels, n_loops, **kw))
                    try:
                        want = jaffinity(n_channels, n_loops, **kw)
                    except ValueError:
                        continue
                    assert channel_affinity(n_channels, n_loops,
                                            **kw) == want


def test_make_leader_plan_and_pod_aligned_groups_grid():
    for n_local in range(1, 9):
        for n_leaders in range(1, 10):
            for flush in ("step", "ready"):
                assert make_leader_plan(n_local, n_leaders, flush) == \
                    jleader_plan(n_local, n_leaders, flush)
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            make_leader_plan(*bad)
    for n in range(1, 13):
        for g in range(1, 10):
            for b in range(1, 6):
                assert pod_aligned_groups(n, g, b) == jpod_groups(n, g, b)


@pytest.mark.parametrize("n_channels", [3, 4, 6])
def test_reshard_affinity_topology_matches_reference(n_channels):
    for leaders in (1, 2):
        if leaders >= n_channels:
            continue
        for n_pods in (1, 2):
            kw = dict(n_pods=n_pods, leaders=leaders)
            for old in range(1, n_channels - leaders + 1):
                groups = jaffinity(n_channels, old, **kw)
                for new in range(1, n_channels + 2):
                    for ll in (1, 2):
                        kws = dict(kw, leader_loops=ll)
                        out = _raises_alike(
                            lambda: elastic.reshard_affinity(
                                n_channels, groups, new, **kws),
                            lambda: jelastic.reshard_affinity(
                                n_channels, groups, new, **kws))
                        if out is not None:
                            assert out[0] == out[1]


# -- the (1, 1) pod ring in this process -------------------------------------


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


@pytest.fixture(scope="module")
def pod_ring(group):
    ring = Ring(channels=4, pods=1, pod_axis="pod")
    yield ring
    ring.close()


@pytest.fixture(scope="module")
def flat_ring(group):
    ring = Ring(channels=4)
    yield ring
    ring.close()


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_config(ARCH)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    return jcfg, get_config(ARCH), jp, npp, from_numpy_params(npp, "cpu")


def test_ring_divisibility_and_layout(group):
    with pytest.raises(ValueError) as want:
        make_serve_mesh(2)
    with pytest.raises(ValueError) as got:
        Ring(channels=2, pods=2, pod_axis="pod")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="in-pod axis"):
        Ring(channels=1, pod_axis="data")
    ring = Ring(channels=2, pods=1, pod_axis="rack")
    try:
        assert ring.axes == ("rack", "data")
        assert ring.shape == {"rack": 1, "data": 1}
        assert (len(ring.in_pod_groups), len(ring.cross_pod_groups)) == \
            (2, 2)
    finally:
        ring.close()
    assert ring.channel_groups == ring.in_pod_groups == \
        ring.cross_pod_groups == ()


def _leader_nested(rec) -> bool:
    """Every leader_flush sits inside a flush span of its own emission."""
    leads = rec.spans_of("leader_flush")
    for s in leads:
        host = obs.containing(rec, s, "flush")
        if host is None or obs.containing(rec, s, "emission") is not \
                obs.containing(rec, host, "emission"):
            return False
    return bool(leads)


@pytest.mark.parametrize("flush", ["ready", "step"])
@pytest.mark.parametrize("kind", ["all_reduce", "all_gather", "all_to_all"])
def test_emit_flat_on_degenerate_pod_ring(pod_ring, flush, kind):
    comm = CommConfig(mode="hadronio", channels=4, aggregate="channel",
                      flush=flush, hierarchical=True, leader_channels=1,
                      slice_bytes=64)
    ctx = SyncContext(comm, ring=pod_ring)
    assert ctx.pod_axis == "pod" and pipeline.leader_emission(ctx, 2)
    x = torch.arange(1003, dtype=torch.float32) * 0.5
    seen = []
    channels_mod.set_collective_hook(lambda c, k: seen.append((c, k)))
    try:
        with obs.capture() as rec:
            y = pipeline.emit_flat(x, ctx, kind)
    finally:
        channels_mod.clear_collective_hook()
    assert torch.equal(y, x)
    kinds = [k for _, k in seen]
    assert obs.well_formed(rec)[0]
    if kind == "all_to_all":              # bypasses the leader split
        assert kinds == ["all_to_all"] * 4
        assert not rec.spans_of("leader_flush")
        return
    local = "in_pod_reduce_scatter" if kind == "all_reduce" \
        else "in_pod_all_gather"
    cross = "cross_pod_all_reduce" if kind == "all_reduce" \
        else "cross_pod_all_gather"
    want = [(c, local) for c in range(3)] + [(3, cross)]
    if kind == "all_reduce":
        want += [(c, "in_pod_all_gather") for c in range(3)]
    assert seen == want
    assert len(rec.spans_of("leader_flush")) == 1
    assert _leader_nested(rec) == (flush == "ready")


@pytest.mark.parametrize("aggregate", ["slice", "channel"])
def test_per_channel_hierarchical_path(pod_ring, aggregate):
    """A one-lane pool (or slice flushes) keeps the channel's own
    two-level all-reduce, noted once as ``all_reduce``."""
    comm = CommConfig(mode="hadronio", channels=1, aggregate=aggregate,
                      hierarchical=True, slice_bytes=64)
    ctx = SyncContext(comm, ring=pod_ring)
    x = torch.randn(1003, generator=torch.Generator().manual_seed(0))
    seen = []
    channels_mod.set_collective_hook(lambda c, k: seen.append(k))
    try:
        assert torch.equal(pipeline.emit_flat(x, ctx, "all_reduce"), x)
    finally:
        channels_mod.clear_collective_hook()
    assert set(seen) == {"all_reduce"}


def test_serve_step_reports_pod_topology_facts(pod_ring, flat_ring, qwen):
    jcfg, tcfg = qwen[0], qwen[1]
    mesh = make_mesh((1, 1), ("pod", "data"))
    for hier in (True, False):
        jcomm = JCommConfig(mode="hadronio", channels=2,
                            aggregate="channel", hierarchical=hier)
        comm = CommConfig(mode="hadronio", channels=2, aggregate="channel",
                          hierarchical=hier)
        want = jdispatch.make_serve_step(jcfg, jcomm, mesh)
        got = dispatch.make_serve_step(tcfg, comm, ring=pod_ring)
        assert (got.pod_axis, got.n_pods) == (want.pod_axis, want.n_pods)
    comm = CommConfig(mode="hadronio", channels=2, aggregate="channel")
    with pytest.raises(ValueError, match="not a mesh axis"):
        dispatch.make_serve_step(tcfg, comm, ring=pod_ring, pod_axis="rack")
    with pytest.raises(ValueError, match="in-pod data axis"):
        dispatch.make_serve_step(tcfg, comm, ring=flat_ring, pod_axis="data")
    with pytest.raises(ValueError, match="not a mesh axis"):
        dispatch.make_serve_step(tcfg, comm, ring=flat_ring, pod_axis="pod")
    with pytest.raises(ValueError, match="in-pod axis"):
        dispatch.make_serve_step(tcfg, comm, ring=pod_ring, pod_axis="data")
    # training over pods waits for the train mesh: the in-pod ZeRO-1
    # scatter group raises with a named error
    with pytest.raises(NotImplementedError, match="item 8"):
        pipeline.scatter_group(SyncContext(comm, ring=pod_ring))
    assert pipeline.scatter_group(SyncContext(comm, ring=flat_ring))[1] == 1
    flat = dispatch.make_serve_step(tcfg, comm, ring=flat_ring)
    assert (flat.pod_axis, flat.n_pods) == (None, 1)


def _reqs(vocab, n=4, seed=11, max_new=3):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(4, 12))),
             max_new) for i in range(n)]


@pytest.fixture(scope="module")
def jax_tokens(qwen):
    """The reference's greedy tokens on its (1, 1) pod mesh, leader
    emission on."""
    jcfg, _, jp, _, _ = qwen
    serve = JServeConfig(
        event_loops=2, poll="busy", max_batch=2, max_len=24,
        comm=JCommConfig(mode="hadronio", slice_bytes=256, channels=4,
                         aggregate="channel", flush="ready",
                         hierarchical=True, leader_channels=1))
    grp = jax_group(jcfg, jp, serve, mesh=make_mesh((1, 1), ("pod", "data")))
    grp.submit([JRequest(u, p, max_new=m)
                for u, p, m in _reqs(jcfg.vocab_size)])
    return {r.uid: tuple(r.tokens.tolist()) for r in grp.run(threads=False)}


def _serve(flush="ready"):
    return ServeConfig(
        event_loops=2, poll="busy", max_batch=2, max_len=24,
        comm=CommConfig(mode="hadronio", slice_bytes=256, channels=4,
                        aggregate="channel", flush=flush,
                        hierarchical=True, leader_channels=1))


@pytest.mark.parametrize("flush", ["ready", "step"])
def test_group_tokens_on_pod_ring_match_reference(pod_ring, qwen, jax_tokens,
                                                  flush):
    _, tcfg, _, _, tp = qwen
    grp = make_engine_group(tcfg, tp, _serve(flush), device="cpu",
                            ring=pod_ring)
    assert grp.ring is pod_ring
    assert [l.channels for l in grp.loops] == [(0, 1), (2, 3)]
    grp.submit([Request(u, p, max_new=m)
                for u, p, m in _reqs(tcfg.vocab_size)])
    got = {r.uid: tuple(r.tokens.tolist()) for r in grp.run(threads=False)}
    assert got == jax_tokens


@pytest.mark.parametrize("scenario", ["dropped_flush", "mem_pressure"])
def test_chaos_seams_on_pod_ring(pod_ring, qwen, scenario):
    """The flush fault and the alloc hook on the leader emission: tokens
    recover, every drop is counted, and the alloc hook is consulted once
    per local-lane flush."""
    _, tcfg, _, _, tp = qwen
    serve = _serve()
    reqs = chaos.make_requests(6, vocab_size=tcfg.vocab_size)
    base = chaos.run_baseline(tcfg, tp, serve, reqs, device="cpu",
                              ring=pod_ring)
    flushes = []
    orig = pipeline._stage_local
    pipeline._stage_local = lambda st, c: (flushes.append(c), orig(st, c))
    try:
        with pipeline.stats_scope() as st:
            res = chaos.run_scenario(scenario, tcfg, tp, serve, reqs,
                                     seed=11, baseline=base, device="cpu",
                                     ring=pod_ring)
    finally:
        pipeline._stage_local = orig
    assert res.report.recovered and res.tokens == base.tokens
    kinds = [f[2] for f in res.fired]
    if scenario == "dropped_flush":
        assert st.drops == kinds.count("drop") > 0
        # a dup verdict issues no shadow flush under leaders
        assert kinds.count("dup") > 0 and st.dups == 0
    else:
        assert kinds.count("pressure") > 0
    assert flushes and st.allocs == len(flushes)
    assert {k for _, k in res.emissions} >= {"in_pod_reduce_scatter",
                                             "cross_pod_all_reduce"}


def test_cli_pods_flags(group, capsys):
    with pytest.raises(ValueError, match="divisors"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--pods", "2",
                        "--comm-mode", "hadronio", "--aggregate", "channel",
                        "--emission", "hierarchical", "--requests", "1"])
    rc = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "2", "--max-new", "2", "--batch", "2",
                         "--comm-mode", "hadronio", "--aggregate", "channel",
                         "--pods", "1", "--emission", "hierarchical",
                         "--leader-channels", "1", "--leader-loops", "1",
                         "--pod-axis", "pod"])
    assert rc == 0 and "[serve] 2 requests, 4 tokens" in capsys.readouterr().out


# -- rings of 2 pods x 2 peers (gloo subprocesses) and JAX on 4 devices ------

MODES = ("hadronio", "hadronio_overlap", "hadronio_overlap_rs")

_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import obs
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import channels as channels_mod
    from repro_torch.core.backends import SyncContext, pipeline
    from repro_torch.core.channels import Ring
    from repro_torch.core.hierarchical import (psum_hierarchical,
                                               psum_scatter_hierarchical)
    from repro_torch.models import api
    from repro_torch.models.convert import from_numpy_params
    from repro_torch.serving import (Request, Supervisor, SupervisorConfig,
                                     dispatch, make_engine_group)

    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        ring = Ring(channels=4, pods=2, pod_axis="pod")
        with open(inp, "rb") as f:
            data = pickle.load(f)
        cfg = get_config("qwen2-0.5b-reduced")
        params = from_numpy_params(data["params"], "cpu")
        res = {"shape": ring.shape}
        ipg, cpg = ring.in_pod_groups[0], ring.cross_pod_groups[0]
        for s in (16, 1003):
            x = torch.as_tensor(np.linspace(0.0, 1.0, 4 * s, dtype=np.float32)
                                .reshape(4, s)[rank])
            w, h = psum_hierarchical(x, cpg, ipg)
            w.wait()
            flat = x.clone()
            dist.all_reduce(flat)
            res["psum", s] = (h.numpy(), flat.numpy())
        x = torch.arange(32, dtype=torch.float32) * (rank + 1)
        w, sh = psum_scatter_hierarchical(x, cpg, ipg)
        w.wait()
        res["scatter"] = sh.numpy()
        try:
            psum_scatter_hierarchical(torch.ones(1003), cpg, ipg)
        except ValueError as e:
            res["scatter_err"] = str(e)

        def comm(mode="hadronio", hier=True, leaders=1, **kw):
            return CommConfig(mode=mode, slice_bytes=512, channels=4,
                              aggregate="channel", flush=kw.pop("flush",
                                                                "ready"),
                              hierarchical=hier, leader_channels=leaders,
                              **kw)

        payload = torch.arange(1003, dtype=torch.float32) + 1000.0 * rank
        for hier in (True, False):
            for flush in ("ready", "step"):
                ctx = SyncContext(comm(hier=hier, flush=flush),
                                  world_size=world, rank=rank, ring=ring)
                res["gather", hier, flush] = pipeline.emit_flat(
                    payload, ctx, "all_gather").numpy()
                red = pipeline.emit_flat(payload, ctx, "all_reduce")
                res["reduce", hier, flush] = red.numpy()

        toks = np.zeros((4, 6), np.int64)
        lens = np.array([4, 5, 6, 3])
        for r in range(4):
            toks[r, :lens[r]] = (np.arange(lens[r]) * (r + 3)) % 256
        batch = {"tokens": torch.as_tensor(toks),
                 "last_pos": torch.as_tensor(lens - 1)}

        def logits(c, count=None, trace=False):
            step = dispatch.make_serve_step(cfg, c, ring=ring)
            assert step.n_shards == 4 and step.n_pods == 2
            assert step.pod_axis == ("pod" if c.hierarchical else None)
            lp, cache = step.prefill(params, batch)
            cache = api.grow_cache(cfg, cache, 24)
            dec = {"token": lp.argmax(-1), "pos": torch.as_tensor(lens)}
            seen = []
            channels_mod.set_collective_hook(lambda ch, k: seen.append(k))
            try:
                with obs.capture() as rec:
                    ld, _ = step.decode(params, cache, dec)
            finally:
                channels_mod.clear_collective_hook()
            if count is not None:
                res["count", count] = (seen.count("cross_pod_all_reduce")
                                       if c.hierarchical
                                       else seen.count("all_reduce"))
            if trace:
                leads = rec.spans_of("leader_flush")
                res["nested"] = bool(leads) and all(
                    obs.containing(rec, s, "flush") is not None
                    and obs.containing(rec, s, "emission") is
                    obs.containing(rec, obs.containing(rec, s, "flush"),
                                   "emission") for s in leads)
                res["well_formed"] = obs.well_formed(rec)[0]
            return lp.numpy(), ld.numpy()

        for mode in ("hadronio", "hadronio_overlap", "hadronio_overlap_rs"):
            for hier in (True, False):
                res["logits", mode, hier] = logits(
                    comm(mode, hier), trace=(mode, hier) == ("hadronio",
                                                             True))
        for leaders, hier in ((1, True), (2, True), (1, False)):
            logits(comm("hadronio_overlap", hier, leaders),
                   count=(leaders, hier))

        reqs = [Request(u, p, max_new=m) for u, p, m in data["reqs"]]

        def serve_cfg(hier, el, leader_loops=None):
            return ServeConfig(event_loops=el, poll="busy", max_batch=2,
                               max_len=24, pods=2,
                               leader_loops=leader_loops or el,
                               comm=comm("hadronio_overlap", hier))

        for el in (1, 2):
            for hier in (True, False):
                g = make_engine_group(cfg, params, serve_cfg(hier, el),
                                      device="cpu", ring=ring)
                if hier:
                    res["affinity", el] = tuple(l.channels for l in g.loops)
                g.submit(reqs)
                got = sorted(g.run(threads=False), key=lambda r: r.uid)
                res["tokens", el, hier] = [tuple(r.tokens.tolist())
                                           for r in got]
        sup = Supervisor(cfg, params, serve_cfg(True, 2, 1), device="cpu",
                         ring=ring, config=SupervisorConfig(
                             dispatch_quantum=2))
        sup.submit(reqs)
        sup.request_resize(1)
        got = sup.run(threads=False)
        res["supervised"] = ([tuple(r.tokens.tolist()) for r in got],
                             [a[1:] for a in sup.healing_trace()],
                             tuple(l.channels for l in sup.group.loops))
        ring.close()
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')

_JAX = textwrap.dedent('''
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import CommConfig
    from repro.configs.registry import get_config
    from repro.launch.mesh import make_serve_mesh
    from repro.models import api
    from repro.serving import dispatch

    inp, out = sys.argv[1:]
    with open(inp, "rb") as f:
        data = pickle.load(f)
    params = jax.tree.map(jnp.asarray, data["params"])
    cfg = get_config("qwen2-0.5b-reduced")
    mesh = make_serve_mesh(2)
    toks = np.zeros((4, 6), np.int32)
    lens = np.array([4, 5, 6, 3], np.int32)
    for r in range(4):
        toks[r, :lens[r]] = (np.arange(lens[r]) * (r + 3)) % cfg.vocab_size
    batch = {"tokens": jnp.asarray(toks), "last_pos": jnp.asarray(lens - 1)}
    comm = CommConfig(mode="hadronio", slice_bytes=512, channels=4,
                      aggregate="channel", flush="ready", hierarchical=True,
                      leader_channels=1)
    step = dispatch.make_serve_step(cfg, comm, mesh)
    lp, cache = step.prefill(params, batch)
    cache = api.grow_cache(cfg, cache, 24)
    ld, _ = step.decode(params, cache, {
        "token": jnp.argmax(lp, -1).astype(jnp.int32),
        "pos": jnp.asarray(lens, jnp.int32)})
    with open(out, "wb") as f:
        pickle.dump((np.asarray(lp), np.asarray(ld)), f)
''')


@pytest.fixture(scope="module")
def pod_rings(qwen, tmp_path_factory):
    """Four gloo peers (2 pods x 2) and the reference on 4 host devices,
    run side by side; every peer's results, checked equal across
    peers, and the reference's logits."""
    tmp = tmp_path_factory.mktemp("pods")
    jcfg = qwen[0]
    data = {"params": qwen[3], "reqs": _reqs(jcfg.vocab_size, n=3, seed=5,
                                             max_new=2)}
    inp = tmp / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "4", str(tmp / "store"),
         str(inp), str(tmp / f"out{r}.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX, str(inp), str(tmp / "jax.pkl")],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = []
    for r in range(4):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for k, v in o.items():
            if k[0] in ("psum", "gather", "reduce", "logits"):
                for a, b in zip(v, outs[0][k]):
                    np.testing.assert_array_equal(a, b)
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return outs, ref


def test_pod_ring_layout_and_psum_hierarchical(pod_rings):
    outs, _ = pod_rings
    res = outs[0]
    assert res["shape"] == {"pod": 2, "data": 2}
    for s in (16, 1003):
        hier, flat = res["psum", s]
        assert hier.shape == (s,)
        np.testing.assert_allclose(hier, flat, rtol=1e-5)
    # each peer's in-pod chunk (index = rank % 2) of the sum over 4 peers
    total = np.arange(32, dtype=np.float32) * sum(range(1, 5))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["scatter"],
                                      total[16 * (r % 2):16 * (r % 2 + 1)])
    assert "divisible by the in-pod ring size 2" in res["scatter_err"]


def test_pod_ring_gathers_bitwise(pod_rings):
    res = pod_rings[0][0]
    want = np.concatenate([np.arange(1003, dtype=np.float32) + 1000.0 * r
                           for r in range(4)])
    for key in [k for k in res if k[0] == "gather"]:
        np.testing.assert_array_equal(res[key], want)
    for flush in ("ready", "step"):
        np.testing.assert_allclose(res["reduce", True, flush],
                                   res["reduce", False, flush], rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_pod_ring_dispatch_flat_vs_hierarchical(pod_rings, mode):
    res = pod_rings[0][0]
    hp, hd = res["logits", mode, True]
    fp, fd = res["logits", mode, False]
    np.testing.assert_array_equal(hp, fp)
    np.testing.assert_allclose(hd, fd, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(hd.argmax(-1), fd.argmax(-1))
    # one emission, whatever the mode: bit for bit across the family
    np.testing.assert_array_equal(hd, res["logits", "hadronio", True][1])


def test_pod_ring_matches_reference(pod_rings):
    outs, (jp, jd) = pod_rings
    hp, hd = outs[0]["logits", "hadronio", True]
    np.testing.assert_allclose(hp, jp, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(hd, jd, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(hd.argmax(-1), jd.argmax(-1))


@pytest.mark.parametrize("el", [1, 2])
def test_pod_ring_tokens_flat_vs_hierarchical(pod_rings, el):
    res = pod_rings[0][0]
    assert res["tokens", el, True] == res["tokens", el, False]
    assert all(len(t) == 2 for t in res["tokens", el, True])
    assert res["affinity", el] == jaffinity(4, el, n_pods=2, leaders=1,
                                            leader_loops=el)


@pytest.mark.parametrize("leaders,hier,want", [(1, True, 1), (2, True, 2),
                                               (1, False, 4)])
def test_pod_ring_cross_pod_collectives(pod_rings, leaders, hier, want):
    assert pod_rings[0][0]["count", (leaders, hier)] == want


def test_pod_ring_leader_flush_nested(pod_rings):
    res = pod_rings[0][0]
    assert res["nested"] and res["well_formed"]


def test_pod_ring_supervised_resize(pod_rings):
    res = pod_rings[0][0]
    tokens, trace, loops = res["supervised"]
    assert tokens == res["tokens", 2, False]
    resizes = [t for t in trace if t[0] == "resize"]
    assert resizes and resizes[0][1] == 1
    want, moved = jelastic.reshard_affinity(
        4, jaffinity(4, 2, n_pods=2, leaders=1, leader_loops=1), 1,
        n_pods=2, leaders=1, leader_loops=1)
    assert loops == want and resizes[0][2][1] == moved
