"""repro_torch's chaos plane against the JAX reference: seeded plans equal
for every scenario and seed, the ``slo`` functions and the elastic
reshard equal on the same inputs, every scenario's served tokens, drain
trace and (for the runtime seams) fired trace equal the reference's on
qwen2-0.5b-reduced, the flush-fault and alloc seams recover with their
counters, an all-``dup`` emission on a gloo ring of 2 equals the
fault-free one bit for bit, and the event-loop seams (fault verdicts,
heartbeats, restarts, structured failures).

The reference's ``test_serve_step_cache_reuse_and_bypass`` has no
counterpart: the port runs eagerly and has no serve-step cache, so its
seams are consulted on every call rather than per trace (the
``serving/chaos.py`` docstring)."""
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

from repro.configs.registry import get_config as jax_config
from repro.launch import elastic as jelastic
from repro.models import api as japi
from repro.serving import EventLoop as JEventLoop
from repro.serving import EventLoopGroup as JEventLoopGroup
from repro.serving import chaos as jchaos
from repro.serving import slo as jslo
from repro_torch.configs.registry import get_config
from repro_torch.core import channels as channels_mod
from repro_torch.core.backends import pipeline
from repro_torch.core.channels import Ring
from repro_torch.launch import elastic
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import (EventLoop, EventLoopGroup, LoopFailure,
                                 Poller, chaos, slo)
from repro_torch.serving.chaos import SCENARIOS, STORM_UID_BASE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b-reduced"
RUNTIME_SEAMS = ("slow_channel", "stalled_loop", "admission_storm",
                 "reshard_mid_request")
TRACE_SEAMS = ("dropped_flush", "mem_pressure")


# ---------------------------------------------------------------------------
# Plans, slo and the elastic reshard: pure functions, equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 11, 1234])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plan_matches_reference(scenario, seed):
    for kw in (dict(n_channels=4, n_loops=2, n_requests=4),
               dict(n_channels=8, n_loops=1, n_requests=8, horizon=32,
                    n_events=6)):
        got = chaos.make_plan(scenario, seed, **kw)
        want = jchaos.make_plan(scenario, seed, **kw)
        assert got.trace() == want.trace() and got.trace()
        assert (got.scenario, got.seed) == (want.scenario, want.seed)


def test_plan_rejects_unknown_scenario():
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        chaos.make_plan("flood", 0)


SAMPLES = {
    "one": [7.0],
    "four": [3e-6, 1e-6, 2e-6, 50e-6],
    "many": list(np.random.default_rng(0).exponential(1e-3, 1001)),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_slo_matches_reference(name):
    xs = SAMPLES[name]
    assert slo.rtt_percentiles(xs) == jslo.rtt_percentiles(xs)
    assert slo.mttr(xs) == jslo.mttr(xs)
    ref = {0: (1, 2), 1: (3,)}
    for served in ({0: (1, 2), 1: (3,), STORM_UID_BASE: (9,)},
                   {0: (1, 2)}, {0: (1, 9), 1: (3,)}):
        assert slo.token_recovery(ref, served) == \
            jslo.token_recovery(ref, served)
    kw = dict(scenario="s", seed=1, mode="hadronio", event_loops=2,
              reference=ref, served={0: (1, 9), 1: (3,)}, fault_rtts=xs,
              baseline_rtts=xs[::-1][:3], n_injected=4)
    got, want = slo.make_report(**kw), jslo.make_report(**kw)
    assert got.p999_inflation == want.p999_inflation
    for field in ("recovered", "mismatched_uids", "fault", "baseline",
                  "n_injected", "healing_actions", "mttr_s"):
        assert getattr(got, field) == getattr(want, field), field
    for check in (lambda m, r: m.assert_slo(r),
                  lambda m, r: m.assert_slo(r, max_p999_inflation=0.5)):
        with pytest.raises(AssertionError) as w:
            check(jslo, want)
        with pytest.raises(AssertionError) as g:
            check(slo, got)
        assert str(g.value) == str(w.value)
    assert slo.mttr([]) is None
    with pytest.raises(ValueError, match="empty"):
        slo.rtt_percentiles([])


@pytest.mark.parametrize("n_channels", [1, 2, 4, 5, 8])
def test_reshard_affinity_matches_reference(n_channels):
    from repro.serving import channel_affinity as jaff
    for old in range(1, n_channels + 1):
        groups = jaff(n_channels, old)
        for new in range(1, n_channels + 2):
            assert elastic._minimal_regroup(n_channels, groups, new) == \
                jelastic._minimal_regroup(n_channels, groups, new)
            if new > n_channels:
                with pytest.raises(ValueError, match="own at least one"):
                    elastic.reshard_affinity(n_channels, groups, new)
                continue
            assert elastic.reshard_affinity(n_channels, groups, new) == \
                jelastic.reshard_affinity(n_channels, groups, new)
    # the topology form (leader lanes, pods) recomputes, as the reference's
    for leaders, n_pods in ((1, 1), (1, 2), (2, 2)):
        old = (tuple(range(n_channels)),)
        for new in range(1, n_channels + 1):
            kw = dict(n_pods=n_pods, leaders=leaders, leader_loops=1)
            try:
                want = jelastic.reshard_affinity(n_channels, old, new, **kw)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    elastic.reshard_affinity(n_channels, old, new, **kw)
                assert str(got.value) == str(e)
                continue
            assert elastic.reshard_affinity(n_channels, old, new,
                                            **kw) == want


def test_reshard_event_loops_revalidates():
    serve = chaos.chaos_serve_config("hadronio", 2)
    assert elastic.reshard_event_loops(serve, 4).event_loops == 4
    with pytest.raises(ValueError, match="exceeds comm.channels"):
        elastic.reshard_event_loops(serve, 5)


# ---------------------------------------------------------------------------
# Served scenarios on qwen2-0.5b-reduced, one-peer gloo ring
# ---------------------------------------------------------------------------


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


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config(ARCH)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, get_config(ARCH), jp, from_numpy_params(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def baselines(model, ring):
    """The fault-free tokens of both packages (hadronio, 1 loop) on the
    harness's four requests: the port's, and the reference's token-only
    baseline."""
    jcfg, tcfg, jp, tp = model
    reqs = chaos.make_requests(4, vocab_size=tcfg.vocab_size)
    base = chaos.run_baseline(tcfg, tp, chaos.chaos_serve_config(
        "hadronio", 1), reqs, device="cpu", ring=ring)
    jbase = jchaos.run_baseline(jcfg, jp, jchaos.chaos_serve_config(
        "hadronio", 1), jchaos.make_requests(4, vocab_size=jcfg.vocab_size))
    assert base.tokens == jbase.tokens and all(base.tokens.values())
    return reqs, base, jchaos.Baseline(tokens=jbase.tokens)


def _run(scenario, model, ring, baselines, *, seed=11, loops=2,
         mode="hadronio"):
    _, tcfg, _, tp = model
    reqs, base, _ = baselines
    return chaos.run_scenario(scenario, tcfg, tp,
                              chaos.chaos_serve_config(mode, loops), reqs,
                              seed=seed, baseline=base, device="cpu",
                              ring=ring)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_matches_reference(scenario, model, ring, baselines):
    """One seeded scenario through both packages (hadronio, 2 loops,
    inline): the same plan, tokens equal to the fault-free run's, the
    same drain trace, and for the runtime seams the same fired trace.
    The flush fault and the alloc hook fire at per-call consult indices
    here and per-trace ones in the reference (checked below)."""
    jcfg, _, jp, _ = model
    _, _, jbase = baselines
    got = _run(scenario, model, ring, baselines)
    want = jchaos.run_scenario(
        scenario, jcfg, jp, jchaos.chaos_serve_config("hadronio", 2),
        jchaos.make_requests(4, vocab_size=jcfg.vocab_size), seed=11,
        baseline=jbase)
    assert got.plan.trace() == want.plan.trace()
    assert got.tokens == want.tokens == jbase.tokens
    assert got.report.recovered and want.report.recovered
    slo.assert_slo(got.report)
    assert got.drains == want.drains
    assert got.moved_channels == want.moved_channels
    if scenario in RUNTIME_SEAMS:
        assert got.fired == want.fired
        assert got.poll_stats.stalls == want.poll_stats.stalls
        assert got.poll_stats.delays == want.poll_stats.delays
    assert got.fired and got.emissions
    assert {c for c, _ in got.emissions} <= set(range(4))
    assert not pipeline.fault_active()
    assert channels_mod.get_collective_hook() is None


@pytest.mark.parametrize("mode", ["hadronio", "hadronio_overlap_rs"])
@pytest.mark.parametrize("loops", [1, 4])
def test_recovery_matrix(mode, loops, model, ring, baselines):
    """Every scenario recovers the fault-free tokens at other loop counts
    and modes of the hadronio family (the port alone; the reference's
    test_recovery_matrix)."""
    _, base, _ = baselines
    for scenario in SCENARIOS:
        res = _run(scenario, model, ring, baselines, seed=5, loops=loops,
                   mode=mode)
        assert res.report.recovered, (scenario, mode, loops)
        assert res.tokens == base.tokens, (scenario, mode, loops)


def test_runtime_seam_evidence(model, ring, baselines):
    """The reference's per-scenario checks: stalls counted per fired
    stall, delays charged to one owner loop, storm uids never leak into
    the recovery comparison, a resize migrates channels."""
    res = _run("stalled_loop", model, ring, baselines)
    assert res.poll_stats.stalls == len(res.fired) > 0
    assert {f[2] for f in res.fired} == {"stall"}
    res = _run("slow_channel", model, ring, baselines)
    assert {f[2] for f in res.fired} == {"delay"}
    assert len({f[1] for f in res.fired}) == 1
    assert res.poll_stats.stalls == 0
    assert res.poll_stats.delays == len(res.fired)
    res = _run("admission_storm", model, ring, baselines)
    assert {f[2] for f in res.fired} == {"burst"}
    assert all(uid < STORM_UID_BASE for uid in res.tokens)
    res = _run("reshard_mid_request", model, ring, baselines)
    e = res.plan.events[0]
    assert res.moved_channels
    assert res.fired == ((max(1, min(3, e.step)), e.target, "resize"),)


@pytest.mark.parametrize("scenario", TRACE_SEAMS)
def test_trace_seams_recover_count_and_replay(scenario, model, ring,
                                              baselines):
    """dropped_flush and mem_pressure in the port: recovery, the
    EmissionStats counters under a stats_scope equal to what fired, and
    a same-seed run replays fired, drains and emissions exactly."""
    _, base, _ = baselines
    runs = []
    for _ in range(2):
        with pipeline.stats_scope() as st:
            runs.append((_run(scenario, model, ring, baselines), st))
    (a, sa), (b, sb) = runs
    assert a.tokens == b.tokens == base.tokens and a.report.recovered
    assert (a.fired, a.drains, a.emissions) == (b.fired, b.drains,
                                                b.emissions)
    assert sa == sb and sa.allocs > 0
    kinds = [f[2] for f in a.fired]
    if scenario == "dropped_flush":
        assert set(kinds) <= {"drop", "dup"} and kinds
        assert (sa.drops, sa.dups) == (kinds.count("drop"),
                                       kinds.count("dup"))
        # every dup is one more collective than the fault-free run's
        with pipeline.stats_scope() as clean:
            free = _run("slow_channel", model, ring, baselines)
        assert len(a.emissions) == len(free.emissions) + sa.dups
        assert sa.allocs == clean.allocs + sa.dups
    else:
        assert set(kinds) == {"pressure"}
        assert sa.drops == sa.dups == 0
        assert all(0 <= f[0] < 16 for f in a.fired)


@pytest.mark.parametrize("scenario", TRACE_SEAMS + ("admission_storm",))
def test_seams_cleared_after_a_raise(scenario, model, ring, baselines):
    """A scenario whose serving raises (a request too long for the
    engine) leaves no seam armed."""
    _, tcfg, _, tp = model
    reqs, base, _ = baselines
    bad = chaos.make_requests(2, vocab_size=tcfg.vocab_size,
                              prompt_len=(60, 61))
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        chaos.run_scenario(scenario, tcfg, tp,
                           chaos.chaos_serve_config("hadronio", 2), bad,
                           seed=11, baseline=base, device="cpu", ring=ring)
    assert not pipeline.fault_active()
    assert not pipeline.flush_fault_active()
    assert not pipeline.alloc_hook_active()
    assert channels_mod.get_collective_hook() is None


def test_collective_hook_and_stats_scope():
    calls = []
    channels_mod.set_collective_hook(lambda c, k: calls.append((c, k)))
    try:
        assert channels_mod.get_collective_hook() is not None
        channels_mod._note(types.SimpleNamespace(index=3), "all_gather")
    finally:
        channels_mod.clear_collective_hook()
    assert calls == [(3, "all_gather")]
    assert channels_mod.get_collective_hook() is None
    outer = pipeline.current_stats()
    with pipeline.stats_scope() as a:
        with pipeline.stats_scope() as b:
            assert pipeline.current_stats() is b
        assert pipeline.current_stats() is a
    assert pipeline.current_stats() is outer is pipeline.EMISSION_STATS


# ---------------------------------------------------------------------------
# A dup on a real ring of 2 is idempotent
# ---------------------------------------------------------------------------

_DUP_WORKER = textwrap.dedent('''
    import pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.backends import SyncContext, pipeline
    from repro_torch.core.channels import Ring
    from repro_torch.models import api
    from repro_torch.serving import chaos

    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        ring = Ring(channels=4)
        res = {}
        rng = np.random.default_rng(rank)
        for kind in ("all_reduce", "all_gather", "reduce_scatter",
                     "all_to_all"):
            for channels, n in ((4, 4), (2, 6)):
                for unpack in (False, True):
                    comm = CommConfig(mode="hadronio", channels=channels,
                                      aggregate="channel", flush="ready")
                    ctx = SyncContext(comm, world_size=world, rank=rank,
                                      ring=ring)
                    items = [torch.as_tensor(rng.normal(size=(8,)),
                                             dtype=torch.float32)
                             for _ in range(n)]
                    got = {}
                    for fault in (None, "dup"):
                        xs = [x.clone() for x in items]
                        if fault:
                            pipeline.set_flush_fault(lambda c: "dup")
                        try:
                            with pipeline.stats_scope() as st:
                                outs = pipeline.emit_through_channels(
                                    xs, ctx, kind, group=world,
                                    unpack=unpack)
                        finally:
                            pipeline.clear_flush_fault()
                        got[fault] = ([o.numpy().copy() for o in outs],
                                      st.dups)
                    res[kind, channels, n, unpack] = (
                        got[None], got["dup"],
                        [x.numpy() for x in items])
        # a served dropped_flush scenario over the ring
        cfg = get_config("qwen2-0.5b-reduced")
        params = api.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
        reqs = chaos.make_requests(4, vocab_size=cfg.vocab_size)
        serve = chaos.chaos_serve_config("hadronio", 2)
        base = chaos.run_baseline(cfg, params, serve, reqs, device="cpu",
                                  ring=ring)
        with pipeline.stats_scope() as st:
            r = chaos.run_scenario("dropped_flush", cfg, params, serve,
                                   reqs, seed=11, baseline=base,
                                   device="cpu", ring=ring)
        res["served"] = (base.tokens, r.tokens, r.report.recovered,
                         tuple(r.fired), (st.drops, st.dups))
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')


def test_dup_is_idempotent_on_a_ring_of_two(tmp_path):
    """Two gloo peers: under an all-dup flush fault every emission kind,
    with one item per channel and several, with and without the
    per-flush unpack, equals the fault-free emission bit for bit (an
    in-place all-reduce reduced twice would give 4x at 2 peers), and a
    served dropped_flush scenario recovers the fault-free tokens."""
    world = 2
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DUP_WORKER, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / f"out{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    inputs = [{k: v[2] for k, v in o.items() if k != "served"}
              for o in outs]
    for o in outs:
        for key, val in o.items():
            if key == "served":
                continue
            (free, dup, _), (kind, channels, n, _) = val, key
            (fo, fdups), (do, ddups) = free, dup
            assert fdups == 0 and ddups == min(channels, n), key
            assert len(fo) == len(do) == n
            for a, b in zip(fo, do):
                np.testing.assert_array_equal(a, b, err_msg=str(key))
            if kind == "all_reduce":      # the sum, not twice it
                for i, a in enumerate(fo):
                    np.testing.assert_allclose(
                        a, inputs[0][key][i] + inputs[1][key][i],
                        rtol=1e-6, atol=1e-6)
        base, tokens, recovered, fired, (drops, dups) = o["served"]
        assert recovered and tokens == base and fired
        assert drops + dups == len(fired) and dups > 0
    assert outs[0]["served"] == outs[1]["served"]


# ---------------------------------------------------------------------------
# Event-loop seams
# ---------------------------------------------------------------------------


def test_poller_fault_verdicts():
    p = Poller("busy")
    verdicts = iter(["stall", "delay", None, "stall"])
    p.fault = lambda poller: next(verdicts)
    x = torch.zeros(2)
    for _ in range(4):
        assert p.wait(x) is x
    assert (p.stats.waits, p.stats.stalls, p.stats.delays,
            p.stats.parks) == (4, 2, 1, 2)


def _loops(loop_cls, n, fail_on=()):
    loops = []
    for i in range(n):
        loop = loop_cls(i, channels=(i,))

        def runner(l, items):
            if l.index in fail_on:
                raise RuntimeError(f"loop {l.index} died")
            return [(l.index, it) for it in items]
        loop.runner = runner
        loops.append(loop)
    return loops


def test_heartbeats_drain_hook_and_restart():
    loops = _loops(EventLoop, 2)
    seen = []
    for l in loops:
        l.drain_hook = lambda loop, items: seen.append((loop.index,
                                                        len(items)))
    g = EventLoopGroup(loops)
    g.submit(list(range(5)))
    assert sorted(g.run(threads=False)) == sorted(
        [(i % 2, i) for i in range(5)])
    g.submit(list(range(2)))
    g.run(threads=True)
    assert seen[:2] == [(0, 3), (1, 2)]            # inline: loop order
    assert sorted(seen[2:]) == [(0, 1), (1, 1)]    # threaded: any order
    assert [l.heartbeats for l in loops] == [2, 2]
    l0 = loops[0]
    l0.engine = types.SimpleNamespace(poller=l0.poller)
    old = l0.poller
    old.fault = lambda p: "stall"
    old.wait(torch.zeros(1))
    before = g.poll_stats()
    new = l0.restart()
    assert new is not old and new.fault is None and l0.engine.poller is new
    assert (new.poll, new.spin_s) == (old.poll, old.spin_s)
    assert l0.restarts == 1 and l0.lifetime_stats == old.stats
    assert g.poll_stats() == before        # lifetime: survives the restart
    new.wait(torch.zeros(1))
    assert l0.poll_stats().waits == old.stats.waits + 1


@pytest.mark.parametrize("threads", [False, True])
def test_loop_failures_match_reference(threads):
    """A loop whose runner raises: the same structured LoopFailure
    records as the reference's, the error raised by default, and with
    raise_on_failure=False the survivors' results returned."""
    recs = []
    for loop_cls, group_cls in ((JEventLoop, JEventLoopGroup),
                                (EventLoop, EventLoopGroup)):
        g = group_cls(_loops(loop_cls, 3, fail_on=(1,)))
        g.submit(list(range(7)))
        with pytest.raises(RuntimeError, match="loop 1 died"):
            g.run(threads=threads)
        g.submit(list(range(3)))      # round robin goes on at loop 1
        res = g.run(threads=threads, raise_on_failure=False)
        assert g.loops[1].failed_items == [0]
        assert isinstance(g.loops[1].error, RuntimeError)
        assert all(i != 1 for i, _ in res)
        recs.append([sorted(res), g.loop_failures]
                    + [(f.loop_index, f.error, f.pending)
                       for f in g.failures])
    assert recs[0] == recs[1]
    assert recs[1][1:] == [2, (1, "RuntimeError('loop 1 died')", 2),
                           (1, "RuntimeError('loop 1 died')", 1)]
    assert isinstance(g.failures[0], LoopFailure)


@pytest.mark.parametrize("threads", [False, True])
def test_interrupts_are_raised_even_without_raise_on_failure(threads):
    loops = _loops(EventLoop, 2)

    def interrupted(l, items):
        raise KeyboardInterrupt
    loops[0].runner = interrupted
    g = EventLoopGroup(loops)
    g.submit([0, 1])
    with pytest.raises(KeyboardInterrupt):
        g.run(threads=threads, raise_on_failure=False)
    assert g.loop_failures == 1 and g.failures[0].loop_index == 0
