"""The port's spans inside the training step, at the serving flush
boundary and around the expert stage (``obs/trace.py``), and the
recorder's clock anchor, on the CPU over a one-peer gloo ring:

* TRAIN — a traced TAC step (hadronio, 2 microbatches, 2 steps) is
  well-formed, each ``step`` holds exactly 2 ``forward``, 2
  ``backward``, 1 ``update`` and the exchange's ``emission``, and its
  losses and parameters are bitwise the untraced run's; the gspmd step
  (one peer, and a (1, 1) ``DeviceMesh``) emits the same kinds;
  ``launch/train.py --trace-out`` writes them with the anchor.
* SERVE — an engine group's traced run opens one ``boundary`` per loop
  boundary (a decode step's, and the one that ends each wave), none
  around a ``decode`` or ``admission``, with tokens equal to the
  untraced run's; a moe serve step through the expert exchange nests
  every exchange ``flush`` of the stage inside ``experts``.
* CLOCK — a span's times map onto the wall clock within the anchor's
  read interval.

Helpers: ``tests/torch_spans.py``."""
import json
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.channels import Ring
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models.common import tree_paths
from repro_torch.obs import trace as obs_trace

import torch_spans as ts

TRAIN_KINDS = {"step", "forward", "backward", "update"}


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


def _children(rec, parent) -> dict:
    """{kind: count} of the spans whose tightest ``parent.kind`` span is
    ``parent``."""
    out: dict = {}
    for s in rec.spans:
        if s is not parent and obs.containing(rec, s, parent.kind) is parent:
            out[s.kind] = out.get(s.kind, 0) + 1
    return out


def test_traced_tac_step_nests_its_phases_bitwise(ring):
    run = ts.train_run("hadronio", microbatches=2)
    off_losses, off = ts.train_steps(run, ring, 2)
    with obs.capture() as rec:
        on_losses, on = ts.train_steps(run, ring, 2)
    ok, problems = obs.well_formed(rec)
    assert ok, problems
    assert on_losses == off_losses
    for (path, a), (_, b) in zip(tree_paths(on.params),
                                 tree_paths(off.params)):
        assert torch.equal(a, b), path
    steps = rec.spans_of("step")
    assert [s.args["step"] for s in steps] == [0, 1]
    for s in steps:
        kids = _children(rec, s)
        assert (kids["forward"], kids["backward"], kids["update"],
                kids["emission"]) == (2, 2, 1, 1), kids
    assert sorted(s.args["microbatch"] for s in rec.spans_of("forward")) \
        == [0, 0, 1, 1]
    # each microbatch's backward after its forward, the update last
    for s in steps:
        inner = sorted((c for c in rec.spans
                        if obs.containing(rec, c, "step") is s
                        and c.kind in ("forward", "backward", "update")),
                       key=lambda c: c.t0)
        assert [c.kind for c in inner] == ["forward", "backward"] * 2 \
            + ["update"]
        em = [c for c in rec.spans_of("emission")
              if obs.containing(rec, c, "step") is s][0]
        assert inner[-2].t1 <= em.t0 and em.t1 <= inner[-1].t0


@pytest.mark.parametrize("on_mesh", [False, True])
def test_gspmd_step_emits_the_same_kinds(ring, on_mesh):
    run = ts.train_run("gspmd", microbatches=2)
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu") \
        if on_mesh else None
    off_losses, _ = ts.train_steps(run, ring, 1, mesh)
    with obs.capture() as rec:
        on_losses, _ = ts.train_steps(run, ring, 1, mesh)
    assert on_losses == off_losses
    assert obs.well_formed(rec)[0]
    assert TRAIN_KINDS <= set(rec.kinds())
    (step,) = rec.spans_of("step")
    kids = _children(rec, step)
    assert (kids["forward"], kids["backward"], kids["update"]) == (2, 2, 1)


def test_engine_boundary_per_loop_boundary(ring):
    off, _ = ts.serve_group(ring)
    with obs.capture() as rec:
        on, grp = ts.serve_group(ring)
    assert on == off and all(off.values())
    ok, problems = obs.well_formed(rec)
    assert ok, problems
    eng = grp.loops[0].engine
    waves = eng.prefills - eng.admit_prefills
    assert eng.admit_prefills > 0
    bounds = rec.spans_of("boundary")
    assert len(bounds) == eng.decode_steps + waves
    for kind in ("decode", "admission", "prefill"):
        for s in rec.spans_of(kind):
            assert obs.containing(rec, s, "boundary") is None, s
    for b in bounds:
        assert obs.containing(rec, b, "drain") is not None, b
        assert not any(obs.containing(rec, s, "boundary") is b
                       for s in rec.spans if s.kind != "boundary")


def test_moe_serve_nests_flush_inside_experts(ring):
    p_off, d_off, layers = ts.moe_serve(ring)
    with obs.capture() as rec:
        p_on, d_on, _ = ts.moe_serve(ring)
    assert torch.equal(p_on, p_off) and torch.equal(d_on, d_off)
    assert obs.well_formed(rec)[0]
    experts = rec.spans_of("experts")
    assert len(experts) == 2 * layers          # a prefill and a decode
    for e in experts:
        kids = _children(rec, e)
        assert kids["emission"] == 2 and kids["flush"] >= 2, kids
    inside = [f for f in rec.spans_of("flush")
              if obs.containing(rec, f, "experts") is not None]
    assert len(inside) >= 2 * len(experts)


def test_anchor_maps_spans_onto_the_wall_clock():
    u0 = time.time_ns()
    with obs.capture() as rec:
        with obs.span("step"):
            time.sleep(0.002)
    u1 = time.time_ns()
    (s,) = rec.spans
    w = max(rec.anchor.width_ns, rec.anchor_end.width_ns)
    assert u0 - w <= rec.unix_ns(s.t0) <= rec.unix_ns(s.t1) <= u1 + w
    assert rec.unix_ns(s.t1) - rec.unix_ns(s.t0) == pytest.approx(
        s.dur * 1e9, abs=2)
    assert rec.anchor.to_unix_ns(rec.epoch * 1e9) == rec.unix_ns(0.0)
    clock = rec.to_chrome()["otherData"]["clock"]
    assert clock["ts0_unix_ns"] == rec.unix_ns(0.0)
    assert clock["anchor"]["width_ns"] == rec.anchor.width_ns
    assert clock["anchor_end"]["unix_ns"] >= clock["anchor"]["unix_ns"]
    a = obs_trace.clock_anchor()
    assert a.width_ns >= 0 and a.perf_ns > 0 and a.unix_ns > 0


def test_train_cli_trace_out(tmp_path, capsys):
    path = tmp_path / "train_trace.json"
    assert train_cli.main([
        "--arch", ts.DENSE, "--device", "cpu", "--steps", "2",
        "--global-batch", "4", "--seq-len", "16", "--microbatches", "2",
        "--trace-out", str(path)]) == 0
    out = capsys.readouterr().out
    assert "[train] span trace -> " in out, out
    assert not obs.enabled()
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    cats = [e["cat"] for e in evs]
    assert TRAIN_KINDS | {"emission"} <= set(cats), set(cats)
    assert cats.count("step") == 2 and cats.count("forward") == 4
    other = doc["otherData"]
    assert other["open_spans"] == 0 and other["forced_closes"] == 0
    assert other["clock"]["anchor_end"] is not None
    ts0 = other["clock"]["ts0_unix_ns"]
    first = min(e["ts"] for e in evs)
    assert abs(ts0 + first * 1e3 - time.time_ns()) < 600e9
