"""repro_torch's telemetry plane (``obs`` and its spans) against the JAX
reference, case for case with ``tests/test_obs.py``:

* REGISTRY — the same operations on the port's and the reference's
  registries give equal snapshot dicts and equal ``to_json`` bytes;
  ``RingLog`` bounds; the scoped emission-stats seam.
* SPANS — the recorder units (nesting and Chrome-trace round trip,
  malformed traces, ring eviction, the inert disabled gate) on both
  packages; a traced serve of the reference's ``obs-tiny`` f32 config
  (params from ``convert.from_numpy_params``) over a one-peer gloo ring
  covers the span taxonomy, is well-formed, and serves tokens equal to
  the untraced run's and the reference's; the supervised heal spans.
* DETERMINISM — same seed + same ChaosPlan => byte-identical
  deterministic snapshot across the hadronio family x event_loops, and
  for every scenario two port runs byte-identical, with the reference's
  key set and the reference's values for every non-emission metric (the
  port's emission counters count per call, the reference's per traced
  shape).
* GATE — ``baseline``'s tolerance bands and ``diff`` reports equal to
  ``repro.obs.baseline``'s on the same rows (its command line,
  ``benchmarks/bench_diff.py``, stays the reference's).

The reference's ``test_leader_flush_nests_inside_local_flush`` has its
counterpart with the pod fabric's tests, in
``tests/test_torch_topology.py`` (``test_emit_flat_on_degenerate_pod_ring``
and ``test_pod_ring_leader_flush_nested``)."""
import json

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro import obs as jobs
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.backends import pipeline as jpipeline
from repro.models import api as japi
from repro.obs import baseline as jbl
from repro.serving import chaos as jchaos
from repro.serving.dispatch import clear_serve_step_cache
from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import pipeline
from repro_torch.core.channels import Ring
from repro_torch.models.convert import from_numpy_params
from repro_torch.obs import baseline as bl
from repro_torch.serving import chaos

import torch_spans

HADRONIO_FAMILY = ("hadronio", "hadronio_rs", "hadronio_overlap",
                   "hadronio_overlap_rs")
TINY = dict(name="obs-tiny", family="dense", num_layers=1, d_model=16,
            num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64, head_dim=8,
            param_dtype="float32", compute_dtype="float32")
# the emission counters: per call in the port, per traced shape in the
# reference (serving/chaos.py), so only their keys are compared; so is
# the injection count of the two scenarios whose seams fire per call
EMISSION_KEYS = ("emission.", "chaos.emissions", "channel.emissions")
TRACE_SEAMS = ("dropped_flush", "mem_pressure")


# ---------------------------------------------------------------------------
# Metrics registry units, each on both packages
# ---------------------------------------------------------------------------


def _both(build):
    """``build(obs_module)`` on the port and on the reference."""
    return build(obs), build(jobs)


def test_registry_sections_and_label_keys():
    def build(o):
        reg = o.MetricsRegistry()
        reg.counter("served", tenant="a", loop=0).inc()
        reg.counter("served", tenant="a", loop=0).inc(2)  # get-or-create
        reg.gauge("depth", loop=1).set(4)
        reg.gauge("spins", volatile=True, loop=1).set(99)
        reg.histogram("rtt", mode="hadronio").observe(1.5)
        reg.histogram("rtt", mode="hadronio").observe(0.5)
        return reg

    reg, jreg = _both(build)
    snap = reg.snapshot()
    assert snap["counters"] == {"served{loop=0,tenant=a}": 3}
    assert snap["gauges"] == {"depth{loop=1}": 4}
    assert snap["volatile"] == {"spins{loop=1}": 99}
    h = snap["histograms"]["rtt{mode=hadronio}"]
    assert h["count"] == 2 and (h["min"], h["max"]) == (0.5, 1.5)
    det = reg.deterministic_snapshot()
    assert set(det) == {"counters", "gauges"}
    assert "spins{loop=1}" not in det["gauges"]
    assert snap == jreg.snapshot()
    assert det == jreg.deterministic_snapshot()
    for kw in ({}, {"deterministic": True}, {"indent": None}):
        assert reg.to_json(**kw) == jreg.to_json(**kw), kw


def test_registry_label_order_independent_and_unknown_rejected():
    for o in (obs, jobs):
        reg = o.MetricsRegistry()
        a = reg.counter("x", loop=1, mode="m")
        b = reg.counter("x", mode="m", loop=1)
        assert a is b
        with pytest.raises(ValueError, match="unknown metric label"):
            reg.counter("x", flavor="nope")
    assert obs.LABEL_KEYS == jobs.LABEL_KEYS


def test_registry_type_conflict_rejected():
    for o in (obs, jobs):
        reg = o.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")


def test_registry_to_json_byte_stable():
    rows = [("b", {"loop": 1}, 2), ("a", {}, 1), ("b", {"loop": 0}, 3.5)]

    def build(o, order):
        reg = o.MetricsRegistry()
        for name, labels, v in order:
            reg.gauge(name, **labels).set(v)
        return reg.to_json(deterministic=True)

    got = build(obs, rows)
    assert got == build(obs, list(reversed(rows)))
    assert got == build(jobs, rows)


def test_ringlog_bounds_dropped_slice_eq():
    r = obs.RingLog(3)
    assert not r and len(r) == 0
    r.extend([1, 2, 3])
    assert r.dropped == 0 and r == [1, 2, 3]
    r.append(4)
    r.append(5)
    assert list(r) == [3, 4, 5] and r.dropped == 2
    assert r[0] == 3 and r[-1] == 5 and r[1:] == [4, 5]
    assert r == (3, 4, 5) and r != [3, 4]
    assert tuple(r) == (3, 4, 5)
    j = jobs.RingLog(3)
    j.extend([1, 2, 3, 4, 5])
    assert list(r) == list(j) and r.dropped == j.dropped
    with pytest.raises(ValueError):
        obs.RingLog(0)


def test_stats_scope_shields_module_global():
    base = pipeline.EMISSION_STATS.drops
    with pipeline.stats_scope() as st:
        pipeline.current_stats().drops += 3
        with pipeline.stats_scope() as inner:     # nested scopes shadow
            pipeline.current_stats().dups += 1
            assert inner.dups == 1
        assert st.drops == 3 and st.dups == 0
    assert pipeline.EMISSION_STATS.drops == base  # global untouched
    assert pipeline.current_stats() is pipeline.EMISSION_STATS


# ---------------------------------------------------------------------------
# Trace recorder units + export round trip, on both packages
# ---------------------------------------------------------------------------


def _nested(o):
    with o.capture() as rec:
        with o.span("emission", "e", items=2):
            with o.span("flush", "ch0", channel=0):
                pass
            with o.span("flush", "ch1", channel=1):
                pass
        o.complete("heal", "restart", 0.0, 0.25, round=1)
    return rec


def _shape(doc: dict) -> list:
    """A Chrome-trace document without its clock readings."""
    return sorted((e["name"], e["cat"], e["ph"], e["pid"], e["tid"],
                   json.dumps(e["args"], sort_keys=True))
                  for e in doc["traceEvents"])


def test_recorder_nesting_and_round_trip(tmp_path):
    rec = _nested(obs)
    assert not obs.enabled()
    ok, problems = obs.well_formed(rec)
    assert ok, problems
    assert rec.kinds() == ["emission", "flush", "heal"]
    doc = json.loads(json.dumps(rec.to_chrome()))
    evs = doc["traceEvents"]
    assert len(evs) == 4
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
    em = [e for e in evs if e["cat"] == "emission"][0]
    for f in (e for e in evs if e["cat"] == "flush"):
        assert em["ts"] <= f["ts"] + 0.01
        assert f["ts"] + f["dur"] <= em["ts"] + em["dur"] + 0.01
    heal = [e for e in evs if e["cat"] == "heal"][0]
    assert abs(heal["dur"] - 0.25e6) < 1e3
    clock = doc["otherData"].pop("clock")     # the port's clock anchor
    assert doc["otherData"] == {"dropped": 0, "forced_closes": 0,
                                "open_spans": 0}
    assert clock["ts0_unix_ns"] == rec.unix_ns(0.0)
    for f in rec.spans_of("flush"):
        assert obs.containing(rec, f, "emission") is not None
    # the same spans through the reference: the same document but clocks
    want = _nested(jobs).to_chrome()
    assert _shape(doc) == _shape(want)
    assert doc["otherData"] == want["otherData"]
    path = tmp_path / "trace.json"
    written = rec.write(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(written))


def test_recorder_detects_malformed():
    for o in (obs, jobs):
        with o.capture() as rec:
            o.begin("emission", "left-open")
        assert rec.open_spans() == [("emission", "left-open")]
        ok, problems = o.well_formed(rec)
        assert not ok and "unclosed" in problems[0]

        with o.capture() as rec2:
            outer = o.begin("emission", "outer")
            o.begin("flush", "inner")
            o.end(outer)               # non-LIFO: inner force-closed
        assert rec2.forced_closes == 1
        assert not o.well_formed(rec2)[0]
        with o.capture() as rec3:      # a token not on the stack
            tok = o.begin("flush", "x")
            o.end(tok)
            o.end(tok)
        assert rec3.forced_closes == 1 and len(rec3.spans) == 1


def test_recorder_ring_eviction_counts():
    for o in (obs, jobs):
        with o.capture(capacity=4) as rec:
            for i in range(7):
                with o.span("decode", f"s{i}"):
                    pass
        assert len(rec.spans) == 4 and rec.dropped == 3
        assert [s.name for s in rec.spans] == ["s3", "s4", "s5", "s6"]
        assert rec.to_chrome()["otherData"]["dropped"] == 3
    assert obs.TraceRecorder().capacity == 65536 == \
        jobs.TraceRecorder().capacity


def test_disabled_gate_is_inert(ring, monkeypatch):
    assert not obs.enabled()
    assert obs.begin("emission") is None
    obs.end(None)                      # must not raise
    with obs.span("decode"):           # shared nullcontext
        pass
    obs.complete("heal", "x", 0.0, 1.0)
    assert obs.recorder() is None
    # the reference's kinds in its order, then the port's own: the
    # training step's, the engine's flush boundary, the expert stage
    assert obs.KINDS[:len(jobs.KINDS)] == jobs.KINDS
    assert obs.KINDS[len(jobs.KINDS):] == (
        "step", "forward", "backward", "update", "boundary", "experts")
    assert obs.__all__ == jobs.__all__
    # the port's sites check the gate before touching the recorder's
    # API: with tracing off, a TAC and a gspmd step, an engine group and
    # a moe step through the expert exchange never reach it
    from repro_torch.obs import trace as obs_trace

    def touched(*a, **k):
        raise AssertionError("a disabled site reached the recorder's API")
    for name in ("span", "begin", "end", "complete"):
        monkeypatch.setattr(obs_trace, name, touched)
    for mode in ("hadronio", "gspmd"):
        torch_spans.train_steps(torch_spans.train_run(mode), ring, 1)
    tokens, _ = torch_spans.serve_group(ring)
    assert all(tokens.values())
    torch_spans.moe_serve(ring)


# ---------------------------------------------------------------------------
# The instrumented serving plane (obs-tiny, f32, one-peer gloo ring)
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
def tiny():
    jcfg = JModelConfig(**TINY)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    clear_serve_step_cache()
    return jcfg, jp, ModelConfig(**TINY), from_numpy_params(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def reference(tiny, ring):
    """Both packages' fault-free tokens on 6 requests (> 1 loop x
    max_batch 2: the admission path and its spans are live)."""
    jcfg, jp, cfg, params = tiny
    reqs = chaos.make_requests(6, vocab_size=cfg.vocab_size)
    base = chaos.run_baseline(cfg, params,
                              chaos.chaos_serve_config("hadronio", 1), reqs,
                              device="cpu", ring=ring)
    jbase = jchaos.run_baseline(
        jcfg, jp, jchaos.chaos_serve_config("hadronio", 1),
        jchaos.make_requests(6, vocab_size=jcfg.vocab_size))
    assert base.tokens == jbase.tokens and all(base.tokens.values())
    return base, reqs


def _baseline(cfg, params, serve, reqs, ring):
    return chaos.run_baseline(cfg, params, serve, reqs, device="cpu",
                              ring=ring)


def test_traced_serve_well_formed_and_token_identical(tiny, reference,
                                                      ring):
    """One traced serve covers the span taxonomy: emission / stage /
    flush from the staged emission (every call in the port), build from
    the step builder, prefill / decode / admission from the engine,
    drain from the event loop; well-formed, and observation only."""
    _, _, cfg, params = tiny
    base, reqs = reference
    serve = chaos.chaos_serve_config("hadronio", 1)
    off = _baseline(cfg, params, serve, reqs, ring)
    with obs.capture() as rec:
        on = _baseline(cfg, params, serve, reqs, ring)
    assert on.tokens == off.tokens == base.tokens
    kinds = set(rec.kinds())
    assert {"emission", "stage", "flush", "build", "prefill", "decode",
            "admission", "drain"} <= kinds, kinds
    ok, problems = obs.well_formed(rec)
    assert ok, problems
    assert rec.forced_closes == 0 and rec.open_spans() == [] \
        and rec.dropped == 0
    for f in rec.spans_of("flush"):
        assert obs.containing(rec, f, "emission") is not None, f
    for s in rec.spans_of("stage"):
        assert obs.containing(rec, s, "emission") is not None, s
    # a prefill or decode call holds its emission; a drain holds them all
    for e in rec.spans_of("emission"):
        assert (obs.containing(rec, e, "prefill")
                or obs.containing(rec, e, "decode")
                or obs.containing(rec, e, "admission")), e
        assert obs.containing(rec, e, "drain") is not None, e
    # one build per engine (no step cache), one emission per call
    assert len(rec.spans_of("build")) == serve.event_loops
    grp_calls = len(rec.spans_of("prefill")) + len(rec.spans_of("decode")) \
        + len(rec.spans_of("admission"))
    assert len(rec.spans_of("emission")) == grp_calls


@pytest.mark.parametrize("mode,el", [("hadronio", 1), ("hadronio", 2),
                                     ("hadronio_overlap", 2)])
def test_tracing_preserves_tokens_per_mode(tiny, reference, ring, mode, el):
    jcfg, jp, cfg, params = tiny
    base, reqs = reference
    serve = chaos.chaos_serve_config(mode, el)
    with obs.capture() as rec:
        res = _baseline(cfg, params, serve, reqs, ring)
    assert res.tokens == base.tokens, (mode, el)
    assert rec.spans_of("emission") and obs.well_formed(rec)[0]
    clear_serve_step_cache()
    with jobs.capture() as jrec:
        want = jchaos.run_baseline(jcfg, jp,
                                   jchaos.chaos_serve_config(mode, el), reqs)
    assert res.tokens == want.tokens
    # the port's engine adds its flush-boundary span to the reference's
    assert set(rec.kinds()) == set(jrec.kinds()) | {"boundary"}


def test_supervised_heal_spans_complete_taxonomy(tiny, reference, ring):
    """A supervised dropped_flush run records >= 4 span kinds including
    emission, flush, admission and heal, and the heal spans carry the
    supervisor's detect->heal windows."""
    _, _, cfg, params = tiny
    base, reqs = reference
    serve = chaos.chaos_serve_config("hadronio", 1)
    with obs.capture() as rec:
        res = chaos.run_supervised("dropped_flush", cfg, params, serve,
                                   reqs, seed=11, baseline=base,
                                   device="cpu", ring=ring)
    assert res.report.recovered and res.tokens == base.tokens
    kinds = set(rec.kinds())
    assert {"emission", "flush", "admission", "heal"} <= kinds, kinds
    assert len(kinds) >= 4
    heals = rec.spans_of("heal")
    assert {s.name for s in heals} >= {"quarantine", "restart"}
    assert [s.name for s in heals] == [k for _, k, _, _ in res.trace]
    assert all(s.dur >= 0 for s in heals)
    ok, problems = obs.well_formed(rec)
    assert ok, problems


def test_emission_that_raises_is_force_closed(tiny, reference, ring):
    """The escalated mem_pressure event raises inside an emission and
    leaves its span open; the next enclosing ``end`` force-closes it and
    counts it, as in the reference, and the run still recovers."""
    _, _, cfg, params = tiny
    base, reqs = reference
    with obs.capture() as rec:
        res = chaos.run_supervised("mem_pressure", cfg, params,
                                   chaos.chaos_serve_config("hadronio", 1),
                                   reqs, seed=11, baseline=base,
                                   device="cpu", ring=ring)
    assert res.report.recovered and res.tokens == base.tokens
    assert ("oom" in [f[2] for f in res.fired]) and rec.forced_closes >= 1
    assert rec.open_spans() == []
    assert "retry" in {k for _, k, _, _ in res.trace}


# ---------------------------------------------------------------------------
# Telemetry determinism
# ---------------------------------------------------------------------------


def _scenario_snapshot(cfg, params, serve, reqs, base, scenario, seed,
                       ring):
    """One seeded chaos run -> the deterministic half of its telemetry,
    as bytes (emission counters through a private stats scope)."""
    with pipeline.stats_scope() as st:
        res = chaos.run_scenario(scenario, cfg, params, serve, reqs,
                                 seed=seed, baseline=base, device="cpu",
                                 ring=ring)
    assert res.report.recovered, (scenario, serve.comm.mode)
    reg = obs.MetricsRegistry()
    obs.publish_emission_stats(reg, st, mode=serve.comm.mode,
                               scenario=scenario)
    obs.publish_chaos(reg, res, mode=serve.comm.mode, scenario=scenario)
    return reg.to_json(deterministic=True)


def _jscenario_snapshot(jcfg, jp, serve, reqs, base, scenario, seed):
    clear_serve_step_cache()
    with jpipeline.stats_scope() as st:
        res = jchaos.run_scenario(scenario, jcfg, jp, serve, reqs,
                                  seed=seed, baseline=base)
    reg = jobs.MetricsRegistry()
    jobs.publish_emission_stats(reg, st, mode=serve.comm.mode,
                                scenario=scenario)
    jobs.publish_chaos(reg, res, mode=serve.comm.mode, scenario=scenario)
    return reg.to_json(deterministic=True)


@pytest.mark.parametrize("mode", HADRONIO_FAMILY)
def test_snapshot_determinism_matrix(tiny, reference, ring, mode):
    """hadronio-family modes x event_loops {1, 2, 4}, dropped_flush: two
    same-seed runs per cell, byte-identical snapshots."""
    _, _, cfg, params = tiny
    base, reqs = reference
    for el in (1, 2, 4):
        serve = chaos.chaos_serve_config(mode, el)
        a, b = (_scenario_snapshot(cfg, params, serve, reqs, base,
                                   "dropped_flush", 5, ring)
                for _ in range(2))
        assert a == b, (mode, el)
        snap = json.loads(a)
        assert any(v > 0 for v in snap["gauges"].values()), (mode, el)


def _split(snap_json: str, scenario: str = ""):
    skip = EMISSION_KEYS + (("chaos.injected",) if scenario in TRACE_SEAMS
                            else ())
    g = json.loads(snap_json)["gauges"]
    return set(g), {k: v for k, v in g.items() if not k.startswith(skip)}


@pytest.mark.parametrize("scenario", chaos.SCENARIOS)
def test_snapshot_determinism_every_scenario(tiny, reference, ring,
                                             scenario):
    """Two port runs byte-identical; the reference's key set, and the
    reference's value for every metric but the emission counters (and
    the injection count of the two per-call seams)."""
    jcfg, jp, cfg, params = tiny
    base, reqs = reference
    serve = chaos.chaos_serve_config("hadronio", 1)
    a = _scenario_snapshot(cfg, params, serve, reqs, base, scenario, 9, ring)
    b = _scenario_snapshot(cfg, params, serve, reqs, base, scenario, 9, ring)
    assert a == b, scenario
    want = _jscenario_snapshot(jcfg, jp, jchaos.chaos_serve_config(
        "hadronio", 1), reqs, jchaos.Baseline(tokens=base.tokens),
        scenario, 9)
    keys, other = _split(a, scenario)
    jkeys, jother = _split(want, scenario)
    assert keys == jkeys, scenario
    assert other == jother, scenario


# ---------------------------------------------------------------------------
# Adapters: live group / supervisor -> registry
# ---------------------------------------------------------------------------


def test_collect_publishes_group_and_supervisor(tiny, reference, ring):
    jcfg, jp, cfg, params = tiny
    base, reqs = reference
    from repro.serving.supervisor import Supervisor as JSupervisor
    from repro_torch.serving.supervisor import Supervisor
    sup = Supervisor(cfg, params, chaos.chaos_serve_config("hadronio", 2),
                     device="cpu", ring=ring, seed=3)
    sup.submit(list(reqs))
    sup.run(threads=False)
    reg = obs.collect(supervisor=sup, mode="hadronio")
    snap = reg.snapshot()
    g = snap["gauges"]
    assert g["group.loops{mode=hadronio}"] == 2
    assert g["supervisor.rounds{mode=hadronio}"] >= 1
    assert g["loop.heartbeats{loop=0,mode=hadronio}"] >= 1
    assert "poll.waits{loop=0,mode=hadronio}" in g
    assert "poll.spins{loop=0,mode=hadronio}" in snap["volatile"]
    assert "poll.spins{loop=0,mode=hadronio}" not in g
    det = json.loads(reg.to_json(deterministic=True))
    assert "volatile" not in det
    clear_serve_step_cache()
    jsup = JSupervisor(jcfg, jp, jchaos.chaos_serve_config("hadronio", 2),
                       seed=3)
    jsup.submit(list(reqs))
    jsup.run(threads=False)
    jsnap = jobs.collect(supervisor=jsup, mode="hadronio").snapshot()
    assert set(snap["volatile"]) == set(jsnap["volatile"])
    keys, other = _split(json.dumps(snap))
    jkeys, jother = _split(json.dumps(jsnap))
    assert keys == jkeys and other == jother


def test_group_poll_stats_survive_restart(tiny, reference, ring):
    _, _, cfg, params = tiny
    base, reqs = reference
    from repro_torch.serving.engine import make_engine_group
    grp = make_engine_group(cfg, params,
                            chaos.chaos_serve_config("hadronio", 2),
                            device="cpu", ring=ring)
    grp.submit(list(reqs))
    grp.run(threads=False)
    before = grp.poll_stats()
    assert before.waits > 0
    grp.loops[0].restart()             # the heal: fresh poller
    after = grp.poll_stats()
    assert after.waits == before.waits, "restart must not reset stats"
    assert grp.loops[0].poller.stats.waits == 0   # poller IS fresh


def test_dispatch_log_ring_is_bounded():
    from repro_torch.serving.event_loop import EventLoop, EventLoopGroup
    loops = [EventLoop(0, channels=(0,), runner=lambda l, items: []),
             EventLoop(1, channels=(1,), runner=lambda l, items: [])]
    grp = EventLoopGroup(loops, tenants=(("a", 1, (0,)), ("b", 1, (1,))),
                         dispatch_log_capacity=4)

    class _Item:
        def __init__(self, tenant):
            self.tenant = tenant

    grp.submit([_Item("a"), _Item("b")] * 5)
    assert len(grp.dispatch_log) == 4
    assert grp.dispatch_log.dropped == 6
    reg = obs.MetricsRegistry()
    obs.publish_group(reg, grp)
    g = reg.snapshot()["gauges"]
    assert g["group.dispatch_log_dropped"] == 6
    assert g["group.dispatch_log_len"] == 4
    assert g["tenant.dispatched{tenant=a}"] == 5


def test_chaos_evidence_rings_bounded(tiny):
    _, _, cfg, _ = tiny
    plan = chaos.make_plan("dropped_flush", 3)
    inj = chaos._Injector(plan, cfg.vocab_size, evidence_capacity=2)
    for i in range(5):
        inj.fired.append((i, 0, "drop"))
    assert len(inj.fired) == 2 and inj.fired.dropped == 3


# ---------------------------------------------------------------------------
# The baseline gate: tolerance bands and diff reports vs the reference
# ---------------------------------------------------------------------------


def _row(metric="rtt_p50", value=10.0, unit="us", kind="measured",
         **over):
    r = {"benchmark": "b", "figure": "f", "mode": "m", "msg_bytes": 1024,
         "channels": 2, "metric": metric, "value": value, "unit": unit,
         "kind": kind, "seed": 0}
    r.update(over)
    return r


def _tol(t) -> tuple:
    return None if t is None else (t.rel, t.abs, t.direction)


def _report(rep) -> list:
    """A DiffReport as plain values (the two packages' dataclasses are
    distinct types), with each delta's label, change and text."""
    # change and describe() need numbers (the reference's raise on a
    # row whose values are strings, as the port's do)
    return [(d.key, d.status, d.base, d.cand, _tol(d.tol), d.label)
            + ((d.change, d.describe()) if not isinstance(d.base, str)
               else ()) for d in rep.deltas] + [rep.ok, rep.summary()]


def _same_diff(base, cand, **kw):
    jkw = {k: ([(p, jbl.Tolerance(t.rel, t.abs, t.direction))
                for p, t in v] if k == "overrides" else v)
           for k, v in kw.items()}
    rep = bl.diff(base, cand, **kw)
    assert _report(rep) == _report(jbl.diff(base, cand, **jkw))
    return rep


def test_tolerance_directions():
    cases = [("lower_is_better", 0.1, 0.0, 10.0, c)
             for c in (10.9, 11.2, 8.0)] + \
        [("higher_is_better", 0.1, 0.0, 10.0, c) for c in (9.5, 8.0, 12.0)] \
        + [("exact", 0.0, 1e-9, 3.0, c) for c in (3.0, 3.0000001)] \
        + [("ignore", 0.0, 0.0, 1.0, 1e9)]
    want = ["ok", "regression", "improved", "ok", "regression", "improved",
            "ok", "regression", "ok"]
    got = [bl.Tolerance(rel=r, abs=a, direction=d).judge(b, c)
           for d, r, a, b, c in cases]
    assert got == want
    assert got == [jbl.Tolerance(rel=r, abs=a, direction=d).judge(b, c)
                   for d, r, a, b, c in cases]


def test_default_policy_by_unit_and_kind():
    rows = [_row(), _row(kind="derived"), _row(unit="ops", kind="derived"),
            _row(unit="count", kind="derived"), _row(unit="GB/s"),
            _row(unit="tok", kind="derived"), _row(unit="s", kind="derived")]
    got = [_tol(bl.default_tolerance(r)) for r in rows]
    assert got[:5] == [(1.0, 0.0, "lower_is_better"),
                       (0.05, 0.0, "lower_is_better"),
                       (0.0, 1e-9, "exact"), (0.0, 0.0, "ignore"),
                       (0.0, 0.0, "ignore")]
    assert got == [_tol(jbl.default_tolerance(r)) for r in rows]
    kw = dict(tol_measured=0.3, tol_derived_time=0.01)
    assert [_tol(bl.default_tolerance(r, **kw)) for r in rows] == \
        [_tol(jbl.default_tolerance(r, **kw)) for r in rows]


def test_diff_statuses_and_seed_excluded_from_identity():
    base = [_row(), _row(metric="ops", unit="ops", kind="derived",
                         value=7.0), _row(metric="gone"),
            _row(metric="label", value="a")]
    cand = [_row(value=25.0, seed=99),            # 2.5x: regression
            _row(metric="ops", unit="ops", kind="derived", value=7.0),
            _row(metric="new"), _row(metric="label", value="b")]
    rep = _same_diff(base, cand)
    assert {d.status for d in rep.deltas} == \
        {"regression", "ok", "missing", "added"}
    assert not rep.ok
    reg = [d for d in rep.regressions if d.key[5] == "rtt_p50"][0]
    assert reg.change == pytest.approx(1.5)


def test_diff_overrides_and_ignore():
    base, cand = [_row()], [_row(value=25.0)]
    assert _same_diff(base, cand,
                      overrides=[("rtt_*", bl.Tolerance(rel=2.0))]).ok
    rep2 = _same_diff(base, cand, ignore=["b:rtt_*"])
    assert rep2.ok and rep2.of("ignored")
    assert not _same_diff(base, cand, tol_measured=0.1).ok


def test_derived_exact_units_trip_on_any_drift(tmp_path):
    base = [_row(metric="emitted_collective_ops", unit="ops",
                 kind="derived", value=8.0)]
    cand = [_row(metric="emitted_collective_ops", unit="ops",
                 kind="derived", value=9.0)]
    assert not _same_diff(base, cand).ok
    base2 = [_row(metric="poll_spins:el2", unit="count", kind="derived",
                  value=100.0)]
    cand2 = [_row(metric="poll_spins:el2", unit="count", kind="derived",
                  value=900000.0)]
    assert _same_diff(base2, cand2).ok
    # the file form: a JSON array, or {"rows": [...]}
    bp, cp = tmp_path / "base.json", tmp_path / "cand.json"
    bp.write_text(json.dumps(base))
    cp.write_text(json.dumps({"rows": cand}))
    assert bl.load_rows(str(cp)) == jbl.load_rows(str(cp)) == cand
    assert _report(bl.diff_files(str(bp), str(cp))) == \
        _report(jbl.diff_files(str(bp), str(cp)))
    assert bl.row_key(base[0]) == jbl.row_key(base[0])
    bad = tmp_path / "bad.json"
    bad.write_text("3")
    with pytest.raises(ValueError, match="JSON array"):
        bl.load_rows(str(bad))


def test_metrics_rows_flatten_deterministic_half():
    """The port's snapshot feeds the reference's benchmark rows as the
    reference's does."""
    from benchmarks.common import metrics_rows

    def build(o):
        reg = o.MetricsRegistry()
        reg.counter("served", tenant="a").inc(5)
        reg.gauge("depth").set(2)
        reg.gauge("spins", volatile=True).set(123)
        return metrics_rows("serving_rtt", reg.snapshot())

    rows, jrows = _both(build)
    assert {r.metric: r.value for r in rows} == \
        {"obs:served{tenant=a}": 5.0, "obs:depth": 2.0}
    assert rows == jrows
