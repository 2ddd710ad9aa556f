"""repro_torch's self-healing supervisor (``serving/supervisor.py``) and
its supervised chaos runner against the JAX reference, case for case
with ``tests/test_supervisor.py``, on the reference's ``sup-tiny`` f32
config (params from ``convert.from_numpy_params``) over a one-peer gloo
ring:

* ``RetryBudget``'s backoff draws equal the reference's for a seed (the
  jitter is a numpy Generator in both);
* every scenario's ``run_supervised``: tokens recovered, every client
  uid ``served``, a non-empty trace that two runs give equal, the kind
  that the scenario maps to, and the reference's canonical trace. The
  four runtime-seam scenarios give exactly the reference's trace; for
  ``dropped_flush`` and ``mem_pressure`` the ``reflush`` entries (whose
  target is the round's drop count, per call here and per traced shape
  there) are the only ones that may differ: every other entry is the
  reference's, in order, and each package's reflush targets sum to its
  own drops;
* retry exhaustion, priority shedding, heartbeat quarantine with queue
  migration, autoscale mid-stream, external resize, the clamp to the
  channel pool, each with the reference's healing trace;
* one batched admission prefill per flush boundary;
* ``Request``'s fields, in the reference's order;
* the supervised, traced CLI and its usage error with ``--tenant``."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import api as japi
from repro.serving import chaos as jchaos
from repro.serving import supervisor as jsupervisor
from repro.serving.dispatch import clear_serve_step_cache
from repro.serving.engine import Request as JRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import pipeline
from repro_torch.core import channels as channels_mod
from repro_torch.core.channels import Ring
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import chaos, slo
from repro_torch.serving.chaos import SCENARIOS, STORM_UID_BASE
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.supervisor import (Outcome, RetryBudget, Supervisor,
                                            SupervisorConfig)

TINY = dict(name="sup-tiny", family="dense", num_layers=1, d_model=16,
            num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8,
            param_dtype="float32", compute_dtype="float32")
RUNTIME_SEAMS = ("slow_channel", "stalled_loop", "admission_storm",
                 "reshard_mid_request")
EXPECT = {
    "slow_channel": {"quarantine"},       # delay EWMA
    "stalled_loop": {"quarantine"},       # stall EWMA
    "dropped_flush": {"retry"},           # drain crash -> retry/backoff
    "admission_storm": {"backpressure"},  # in-wave gate
    "reshard_mid_request": {"resize"},    # external elasticity
    "mem_pressure": {"retry"},            # alloc abort -> retry
}


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
def tiny():
    jcfg = JModelConfig(**TINY)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    clear_serve_step_cache()
    return jcfg, jp, ModelConfig(**TINY), from_numpy_params(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def reference(tiny, ring):
    """One fault-free token reference for the module (tokens do not
    depend on mode, affinity or loop count), equal in both packages."""
    jcfg, jp, cfg, params = tiny
    reqs = chaos.make_requests(4, vocab_size=cfg.vocab_size)
    base = chaos.run_baseline(cfg, params,
                              chaos.chaos_serve_config("hadronio", 1), reqs,
                              device="cpu", ring=ring)
    jbase = jchaos.run_baseline(jcfg, jp,
                                jchaos.chaos_serve_config("hadronio", 1),
                                reqs)
    assert base.tokens == jbase.tokens and all(base.tokens.values())
    return chaos.Baseline(tokens=base.tokens), reqs


@pytest.fixture(scope="module")
def runs(tiny, reference, ring):
    """Each scenario's supervised runs, made once and shared: two of the
    port's and one of the reference's, hadronio, 2 loops, seed 11."""
    jcfg, jp, cfg, params = tiny
    base, reqs = reference
    cache = {}

    def get(scenario):
        if scenario not in cache:
            port = [chaos.run_supervised(
                scenario, cfg, params, chaos.chaos_serve_config("hadronio", 2),
                reqs, seed=11, baseline=base, device="cpu", ring=ring)
                for _ in range(2)]
            want = jchaos.run_supervised(
                scenario, jcfg, jp, jchaos.chaos_serve_config("hadronio", 2),
                reqs, seed=11, baseline=jchaos.Baseline(tokens=base.tokens))
            cache[scenario] = (*port, want)
        return cache[scenario]
    return get


def _tokens(results) -> dict:
    return {r.uid: tuple(np.asarray(r.tokens).tolist()) for r in results}


def _supervisors(tiny, ring, loops, **kw):
    """The same Supervisor in both packages (the reference's on its
    default one-device mesh)."""
    jcfg, jp, cfg, params = tiny
    clear_serve_step_cache()
    return (Supervisor(cfg, params, chaos.chaos_serve_config("hadronio",
                                                             loops),
                       device="cpu", ring=ring, **kw),
            jsupervisor.Supervisor(jcfg, jp,
                                   jchaos.chaos_serve_config("hadronio",
                                                             loops), **kw))


# ---------------------------------------------------------------------------
# RetryBudget: seeded, capped, bounded backoff
# ---------------------------------------------------------------------------


def test_retry_budget_backoff_deterministic_and_bounded():
    b = RetryBudget(limit=4, base_s=1e-3, cap_s=4e-3, jitter=0.25)
    jb = jsupervisor.RetryBudget(limit=4, base_s=1e-3, cap_s=4e-3,
                                 jitter=0.25)
    seq = [b.backoff_s(a, np.random.default_rng(7)) for a in range(6)]
    assert seq == [b.backoff_s(a, np.random.default_rng(7))
                   for a in range(6)]
    for a, s in enumerate(seq):
        raw = min(b.cap_s, b.base_s * 2 ** a)
        assert raw * (1 - b.jitter) - 1e-12 <= s \
            <= raw * (1 + b.jitter) + 1e-12
    assert seq[4] <= b.cap_s * (1 + b.jitter)
    # one Generator drawn in turn, as the supervisor draws it: the
    # reference's draws, bit for bit
    for seed in (0, 3, 11):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [b.backoff_s(a, rng) for a in range(8)] == \
            [jb.backoff_s(a, jrng) for a in range(8)]
    b0 = RetryBudget(jitter=0.0, base_s=1e-3, cap_s=4e-3)
    rng = np.random.default_rng(0)
    assert [b0.backoff_s(a, rng) for a in range(4)] == \
        [1e-3, 2e-3, 4e-3, 4e-3]
    assert RetryBudget() == RetryBudget(**dataclasses.asdict(
        jsupervisor.RetryBudget()))
    assert dataclasses.asdict(SupervisorConfig()) == \
        dataclasses.asdict(jsupervisor.SupervisorConfig())


# ---------------------------------------------------------------------------
# Every scenario recovers UNDER the supervisor, with the reference's trace
# ---------------------------------------------------------------------------


def _without_reflush(trace) -> tuple:
    return tuple(a for a in trace if a[1] != "reflush")


def _reflush_total(trace) -> int:
    return sum(a[2] for a in trace if a[1] == "reflush")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_supervised_recovery_and_trace_determinism(reference, runs,
                                                   scenario):
    base, reqs = reference
    a, b, want = runs(scenario)
    assert a.plan == b.plan and a.plan.trace() == want.plan.trace()
    assert a.fired == b.fired and a.drains == b.drains
    assert a.tokens == b.tokens == base.tokens == want.tokens
    assert a.report.recovered and b.report.recovered
    assert a.report.n_injected > 0
    assert a.trace, scenario
    assert a.trace == b.trace, scenario
    assert a.report.healing_actions == len(a.trace) > 0
    assert {u: o.status for u, o in a.outcomes.items()
            if u < STORM_UID_BASE} == {r.uid: "served" for r in reqs}
    assert {u: (o.status, o.attempts) for u, o in a.outcomes.items()} == \
        {u: (o.status, o.attempts) for u, o in want.outcomes.items()}
    slo.assert_slo(a.report)
    if scenario in RUNTIME_SEAMS:
        assert a.trace == want.trace, scenario
        assert a.fired == want.fired and a.drains == want.drains
    else:
        assert _without_reflush(a.trace) == _without_reflush(want.trace)
        drops = [f for f in a.fired if f[2] == "drop"]
        assert _reflush_total(a.trace) == len(drops), a.trace
        assert _reflush_total(want.trace) == \
            len([f for f in want.fired if f[2] == "drop"])
    assert not pipeline.fault_active()
    assert channels_mod.get_collective_hook() is None


def test_supervised_scenarios_map_to_expected_healing(runs):
    """Each fault class exercises ITS healing mechanism."""
    for scenario, kinds in EXPECT.items():
        a, _, want = runs(scenario)
        got = {k for _, k, _, _ in a.trace}
        assert kinds <= got, (scenario, a.trace)
        assert got - {"reflush"} == \
            {k for _, k, _, _ in want.trace} - {"reflush"}


# ---------------------------------------------------------------------------
# Retry exhaustion: structured surfacing, never a hang
# ---------------------------------------------------------------------------


def test_retry_exhaustion_surfaces_structured_outcome(tiny, reference, ring):
    base, reqs = reference
    kw = dict(limit=2, base_s=1e-6, cap_s=1e-6, jitter=0.0, deadline_s=5.0)
    sup, jsup = _supervisors(
        tiny, ring, 2, seed=3,
        config=SupervisorConfig(retry=RetryBudget(**kw)))
    jsup.config = jsupervisor.SupervisorConfig(
        retry=jsupervisor.RetryBudget(**kw))

    def wedge(grp):
        def crash(loop, items):
            raise RuntimeError("wedged NIC")
        grp.loops[0].drain_hook = crash   # survives restart (loop attr)

    for s in (sup, jsup):
        s.fleet_hook = wedge
        s.submit(reqs)
    results = sup.run()                   # returns; never hangs
    jsup.run()
    dead = {u for u, o in sup.outcomes.items()
            if o.status == "retry_exhausted"}
    assert dead == {0, 2}                 # round-robin: loop 0's uids
    for u in dead:
        o = sup.outcomes[u]
        assert "wedged NIC" in o.reason
        assert o.attempts == kw["limit"] + 1
        assert o == Outcome(**dataclasses.asdict(jsup.outcomes[u]))
    assert _tokens(results) == {u: t for u, t in base.tokens.items()
                                if u in (1, 3)}
    ex = next(a for a in sup.trace if a.kind == "retry_exhausted")
    assert ex.detail[0] == kw["limit"] and ex.detail[1] == (0, 2)
    assert sup.healing_trace() == jsup.healing_trace()


def test_retry_lets_an_interrupt_through(tiny, reference, ring):
    """A retry catches ``Exception`` only: an interrupt raised by a
    retried drain propagates instead of being retried or recorded."""
    base, reqs = reference
    sup, _ = _supervisors(tiny, ring, 2, seed=3)
    calls = []

    def wedge(grp):
        def crash(loop, items):
            calls.append(loop.index)
            if len(calls) == 1:
                raise RuntimeError("first drain fails")
            raise KeyboardInterrupt
        grp.loops[0].drain_hook = crash

    sup.fleet_hook = wedge
    sup.submit(reqs)
    with pytest.raises(KeyboardInterrupt):
        sup.run()
    assert calls == [0, 0]
    assert channels_mod.get_collective_hook() is None


# ---------------------------------------------------------------------------
# Bounded admission queue: lowest-priority shedding
# ---------------------------------------------------------------------------


def test_admission_queue_sheds_lowest_priority(tiny, ring):
    sup, jsup = _supervisors(tiny, ring, 1,
                             config=SupervisorConfig(admission_capacity=2))
    jsup.config = jsupervisor.SupervisorConfig(admission_capacity=2)
    for s, R in ((sup, Request), (jsup, JRequest)):
        mk = lambda uid, pri: R(uid, np.asarray([3, 4]), max_new=2,
                                priority=pri)
        s.submit([mk(0, 0), mk(1, 1)])    # fills the queue
        assert len(s.queue) == 2 and not s.outcomes
        s.submit(mk(2, 0))                # no higher than the floor: shed
        assert [r.uid for r in s.queue] == [0, 1]
        s.submit(mk(3, 2))                # evicts the lowest (uid 0)
        assert sorted(r.uid for r in s.queue) == [1, 3]
    assert sup.outcomes[2] == Outcome(2, "rejected",
                                      "admission_queue_full", 0)
    assert sup.outcomes[0].status == "rejected"
    sheds = [a for a in sup.trace if a.kind == "shed"]
    assert [(a.target, a.detail) for a in sheds] == [(2, (0,)), (0, (0,))]
    assert sup.healing_trace() == jsup.healing_trace()


def test_admission_gate_sheds_in_wave_burst(tiny, reference, ring):
    """The engine's gate sees an injected burst after the hook: over the
    in-wave budget the lowest-priority requests are shed."""
    base, reqs = reference
    sup, jsup = _supervisors(tiny, ring, 1,
                             config=SupervisorConfig(admission_capacity=2))
    jsup.config = jsupervisor.SupervisorConfig(admission_capacity=2)
    for s, R in ((sup, Request), (jsup, JRequest)):
        def hook(engine, step, R=R):
            if step != 1:
                return []
            return [R(STORM_UID_BASE + k, np.asarray([5, 6, 7]), max_new=1,
                      priority=k) for k in range(3)]

        def arm(grp, hook=hook):
            for l in grp.loops:
                l.engine.admission_hook = hook
        s.fleet_hook = arm
        s.submit(reqs[:2])             # within the queue's capacity
        s.run()
    assert sup.healing_trace() == jsup.healing_trace()
    kinds = [k for _, k, _, _ in sup.healing_trace()]
    assert kinds == ["backpressure", "shed"]
    assert sup.outcomes[STORM_UID_BASE].status == "rejected"
    assert {u: o.status for u, o in sup.outcomes.items()} == \
        {u: o.status for u, o in jsup.outcomes.items()}


# ---------------------------------------------------------------------------
# Heartbeat quarantine: detected by rounds, queue migrated to survivors
# ---------------------------------------------------------------------------


def test_heartbeat_quarantine_migrates_queue(tiny, reference, ring):
    base, reqs = reference
    sup, jsup = _supervisors(tiny, ring, 2, seed=0)

    def wedge(grp):
        grp.loops[0].drain = lambda: []   # no beat, queue kept: wedged

    for s in (sup, jsup):
        s.fleet_hook = wedge
        s.submit(reqs)
    results = sup.run()
    jsup.run()
    q = [a for a in sup.trace if a.kind == "quarantine"]
    assert q and q[0].target == 0
    assert q[0].detail[0] == "heartbeat"
    assert q[0].detail[3] == 2            # uids 0,2 migrated off loop 0
    assert _tokens(results) == base.tokens
    assert all(sup.outcomes[r.uid].status == "served" for r in reqs)
    assert sup.healing_trace() == jsup.healing_trace()


# ---------------------------------------------------------------------------
# Elasticity mid-stream: autoscale and external resize, token identity
# ---------------------------------------------------------------------------


def test_autoscale_grows_mid_stream_with_token_identity(tiny, reference,
                                                        ring):
    base, reqs = reference
    kw = dict(dispatch_quantum=1, scale_up_depth=1.0, hysteresis=2,
              cooldown_rounds=0)
    sup, jsup = _supervisors(tiny, ring, 1, seed=0,
                             config=SupervisorConfig(**kw))
    jsup.config = jsupervisor.SupervisorConfig(**kw)
    sup.submit(reqs)
    results = sup.run()
    resizes = [a for a in sup.trace if a.kind == "resize"]
    assert resizes, sup.healing_trace()
    first = resizes[0]
    assert first.detail[2] == "queue_depth"
    assert first.target == 2 and first.detail[0] == 1     # grew 1 -> 2
    assert 1 <= first.round < sup.rounds
    assert sup.group.n_loops >= 2
    moved = first.detail[1]
    assert set(moved) <= set(sup.group.loops[-1].channels) or \
        len(resizes) > 1
    assert _tokens(results) == base.tokens
    jsup.submit(reqs)
    jsup.run()
    assert sup.healing_trace() == jsup.healing_trace()
    assert tuple(l.channels for l in sup.group.loops) == \
        tuple(l.channels for l in jsup.group.loops)


def test_external_resize_applies_at_round_boundary(tiny, reference, ring):
    base, reqs = reference
    sup, jsup = _supervisors(tiny, ring, 1, seed=0,
                             config=SupervisorConfig(dispatch_quantum=2))
    jsup.config = jsupervisor.SupervisorConfig(dispatch_quantum=2)
    for s in (sup, jsup):
        s.request_resize(3)
        s.submit(reqs)
    results = sup.run()
    jsup.run()
    resizes = [a for a in sup.trace if a.kind == "resize"]
    assert len(resizes) == 1
    assert resizes[0].target == 3
    assert resizes[0].detail[0] == 1 and resizes[0].detail[2] == "requested"
    assert sup.group.n_loops == 3
    assert tuple(l.channels for l in sup.group.loops) == \
        tuple(sup._affinity)
    assert _tokens(results) == base.tokens
    assert sup.healing_trace() == jsup.healing_trace()


def test_resize_is_clamped_to_channel_pool(tiny, ring):
    sup, _ = _supervisors(tiny, ring, 2)
    sup.request_resize(99)
    sup.submit(Request(0, np.asarray([3, 4]), max_new=2))
    sup.run()
    assert sup.group.n_loops == sup.serve.comm.channels == 4
    assert [a.kind for a in sup.trace] == ["resize"]


def test_max_rounds_bounds_a_run_that_does_not_converge(tiny, ring):
    sup, _ = _supervisors(tiny, ring, 1,
                          config=SupervisorConfig(max_rounds=3))

    def wedge(grp):
        grp.loops[0].drain = lambda: []   # never drains, never beats
    sup.fleet_hook = wedge
    sup.submit(Request(0, np.asarray([3, 4]), max_new=2))
    with pytest.raises(RuntimeError, match="max_rounds=3"):
        sup.run()
    assert channels_mod.get_collective_hook() is None


# ---------------------------------------------------------------------------
# Batched admission: one prefill per flush boundary, not per request
# ---------------------------------------------------------------------------


def _counting_engine(cfg, params, **kw):
    """Engine emitting ``(previous token + 1) % vocab`` with stubbed
    prefill/decode: isolates the admission path."""
    eng = DecodeEngine(cfg, params, device="cpu", **kw)
    V = cfg.vocab_size
    eye = torch.eye(V) * 10.0

    def fake_prefill(p, batch):
        toks, last = batch["tokens"], batch["last_pos"]
        prev = toks[torch.arange(toks.shape[0]), last]
        return eye[(prev + 1) % V], {"k": torch.zeros(1, toks.shape[0], 4)}

    def fake_decode(p, cache, dec):
        return eye[(dec["token"] + 1) % V], cache

    eng._prefill = fake_prefill
    eng._decode = fake_decode
    return eng


def test_batched_admission_one_prefill_per_boundary(tiny):
    """Three residents finish at the same flush boundary; both queued
    requests are admitted by ONE batched prefill, and every stream is
    exact."""
    _, _, cfg, params = tiny
    eng = _counting_engine(cfg, params, max_batch=3, max_len=32)
    reqs = [Request(u, np.asarray([1, 10 * u + 5]), max_new=2)
            for u in range(5)]
    res = eng.generate(reqs)
    assert eng.admit_prefills == 1
    assert _tokens(res) == {
        u: (10 * u + 6, 10 * u + 7) for u in range(5)}


# ---------------------------------------------------------------------------
# Request's fields and the CLI
# ---------------------------------------------------------------------------


def test_request_fields_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(Request)] == \
        [(f.name, f.default) for f in dataclasses.fields(JRequest)]
    r = Request(7, [1, 2], 3, 0.5, 2, "chat")     # positional, in order
    j = JRequest(7, [1, 2], 3, 0.5, 2, "chat")
    assert (r.priority, r.tenant) == (j.priority, j.tenant) == (2, "chat")


def test_supervised_traced_cli(ring, tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    assert serve_cli.main([
        "--arch", "qwen2-0.5b-reduced", "--device", "cpu", "--requests",
        "6", "--max-new", "3", "--batch", "2", "--event-loops", "1",
        "--supervised", "--max-loops", "2", "--scale-up-depth", "1",
        "--dispatch-quantum", "2", "--comm-mode", "hadronio",
        "--aggregate", "channel", "--flush", "ready",
        "--trace-out", str(trace), "--metrics-out", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "[serve] 6 requests, 18 tokens" in out, out
    assert "[serve] supervisor: " in out and " resize target=2 " in out, out
    assert "[serve] span trace -> " in out and "[serve] metrics snapshot" \
        in out
    doc = json.loads(trace.read_text())
    cats = {e["cat"] for e in doc["traceEvents"]}
    assert {"build", "prefill", "decode", "drain", "emission", "stage",
            "flush", "heal"} <= cats, cats
    assert doc["otherData"] == {"dropped": 0, "forced_closes": 0,
                                "open_spans": 0}
    snap = json.loads(metrics.read_text())
    assert snap["gauges"]["group.loops{mode=hadronio}"] == 2
    assert snap["gauges"]["heal.actions{kind=resize,mode=hadronio}"] >= 1
    assert snap["gauges"]["outcome.requests{kind=served,mode=hadronio}"] \
        == 6


def test_supervised_with_tenant_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--device", "cpu", "--supervised", "--tenant",
                        "chat=qwen2-0.5b-reduced:2"])
    assert e.value.code == 2
    assert "--supervised requires a single-tenant group" in \
        capsys.readouterr().err
