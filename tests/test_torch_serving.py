"""repro_torch serving on qwen2-0.5b-reduced (f32, CPU): greedy tokens of
the port's event-loop group against the JAX reference group on the same
params and requests, plus the poller, event loops, dispatch, CLI and
the no-quiet-CPU rule."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jax_config
from repro.models import api as japi
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro.serving import channel_affinity as jax_affinity
from repro.serving import make_engine_group as jax_group
from repro_torch.configs.base import CommConfig, ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import (DecodeEngine, EventLoop, EventLoopGroup,
                                 Poller, PollStats, Request,
                                 channel_affinity, dispatch,
                                 make_engine_group)

ARCH = "qwen2-0.5b-reduced"


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _requests(n=6, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(3, 24))),
             3 + i % 3) for i in range(n)]


def _tokens(results):
    return [tuple(r.tokens.tolist()) for r in sorted(results,
                                                     key=lambda r: r.uid)]


@pytest.mark.parametrize("event_loops", [1, 2])
def test_group_greedy_tokens_match_jax(qwen, event_loops):
    """6 mixed-length requests through max_batch=2 slots (continuous
    admission runs), threaded loops: the port's tokens are the JAX
    group's tokens."""
    jcfg, tcfg, jp, tp = qwen
    reqs = _requests()
    jserve = JServeConfig(event_loops=event_loops, poll="busy", max_batch=2,
                          max_len=48, comm=JCommConfig(mode="gspmd"))
    jg = jax_group(jcfg, jp, jserve)
    jg.submit([JRequest(u, p, max_new=m) for u, p, m in reqs])
    want = _tokens(jg.run(threads=True))
    serve = ServeConfig(event_loops=event_loops, poll="busy", max_batch=2,
                        max_len=48, comm=CommConfig(mode="gspmd"))
    tg = make_engine_group(tcfg, tp, serve, device="cpu")
    tg.submit([Request(u, p, max_new=m) for u, p, m in reqs])
    got = _tokens(tg.run(threads=True))
    assert got == want
    assert [len(t) for t in got] == [m for _, _, m in reqs]
    assert sum(l.engine.admit_prefills for l in tg.loops) > 0
    owned = sorted(c for l in tg.loops for c in l.channels)
    assert owned == list(range(serve.comm.channels))
    assert all(l.results for l in tg.loops)


def test_engine_without_serve_matches_jax(qwen):
    """The plain engine (steps straight from models/api, no dispatch)."""
    jcfg, tcfg, jp, tp = qwen
    reqs = _requests(5, seed=1)
    want = _tokens(JDecodeEngine(jcfg, jp, max_batch=2, max_len=48).generate(
        [JRequest(u, p, max_new=m) for u, p, m in reqs]))
    eng = DecodeEngine(tcfg, tp, max_batch=2, max_len=48, device="cpu")
    got = _tokens(eng.generate([Request(u, p, max_new=m)
                                for u, p, m in reqs]))
    assert got == want
    assert eng.prefills == 1 + eng.admit_prefills


def test_eos_and_max_new_zero(qwen):
    _, tcfg, _, tp = qwen
    eng = DecodeEngine(tcfg, tp, max_batch=1, max_len=48, device="cpu")
    first = eng.generate([Request(0, np.arange(5), max_new=6)])[0].tokens
    eos = int(first[1])
    eng2 = DecodeEngine(tcfg, tp, max_batch=1, max_len=48, eos_id=eos,
                        device="cpu")
    res = eng2.generate([Request(0, np.arange(5), max_new=6),
                         Request(1, np.arange(4), max_new=0),     # admitted
                         Request(2, np.arange(7), max_new=2)])    # admitted
    assert res[0].tokens[-1] == eos and len(res[0].tokens) <= 2
    assert len(res[1].tokens) == 0 and len(res[2].tokens) >= 1
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([Request(0, np.arange(40), max_new=9)])


def test_temperature_sampling_is_seeded(qwen):
    _, tcfg, _, tp = qwen
    reqs = [Request(i, np.arange(4 + i), max_new=5, temperature=1.0)
            for i in range(3)]
    run = lambda seed: _tokens(DecodeEngine(
        tcfg, tp, max_batch=2, max_len=48, seed=seed,
        device="cpu").generate(reqs))
    a, b = run(3), run(3)
    assert a == b
    assert all(0 <= t < tcfg.vocab_size for toks in a for t in toks)


def test_gathering_write_path_matches_local_path(qwen):
    """With a channel affinity the step runs the wired path (one flat
    gathering write for prefill, the TP head for decode); at ring size 1
    it must equal the pure local path exactly."""
    _, tcfg, _, tp = qwen
    local = dispatch.make_serve_step(tcfg, CommConfig())
    wired = dispatch.make_serve_step(tcfg, CommConfig(),
                                     channel_indices=(0, 1))
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 11)))
    batch = {"tokens": toks, "last_pos": torch.tensor([10, 6])}
    la, ca = local.prefill(tp, batch)
    lb, cb = wired.prefill(tp, batch)
    assert torch.equal(la, lb) and torch.equal(ca["k"], cb["k"]) \
        and torch.equal(ca["v"], cb["v"])
    dec = {"token": torch.tensor([3, 4]), "pos": torch.tensor([11, 7])}
    from repro_torch.models import api
    ca, cb = api.grow_cache(tcfg, ca, 16), api.grow_cache(tcfg, cb, 16)
    da, _ = local.decode(tp, ca, dec)
    db, _ = wired.decode(tp, cb, dec)
    assert torch.equal(da, db)


# -- poller and event loops --------------------------------------------------


class _Event:
    """A completion handle (``torch.cuda.Event`` shape) ready after N
    queries."""

    def __init__(self, ready_after):
        self.left = ready_after
        self.synced = False

    def query(self):
        self.left -= 1
        return self.left <= 0

    def synchronize(self):
        self.synced = True
        self.left = 0


@pytest.mark.parametrize("poll,spin_s,spins,parks", [
    ("busy", 1.0, 0, 0), ("park", 1.0, 0, 1), ("adaptive", 1.0, 0, 0),
    ("adaptive", 0.0, 0, 1)])
def test_poller_cpu_tensors_are_ready(poll, spin_s, spins, parks):
    p = Poller(poll, spin_s=spin_s)
    tree = {"logits": torch.zeros(2, 3), "cache": [torch.ones(4)]}
    assert p.wait(tree) is tree
    assert (p.stats.spins, p.stats.parks, p.stats.waits) == (spins, parks, 1)


def test_poller_counters_on_slow_completion():
    busy = Poller("busy")
    ev = _Event(ready_after=5)
    busy.wait([torch.zeros(1), ev])
    assert busy.stats.spins == 4 and busy.stats.parks == 0 and not ev.synced
    park = Poller("park")
    ev = _Event(ready_after=10**9)
    park.wait(ev)
    assert park.stats.spins == 0 and park.stats.parks == 1 and ev.synced
    adaptive = Poller("adaptive", spin_s=0.0)
    adaptive.wait(_Event(ready_after=10**9))
    assert (adaptive.stats.spins, adaptive.stats.parks) == (0, 1)
    merged = busy.stats.merge(park.stats)
    assert merged == PollStats(spins=4, parks=1, waits=2)
    with pytest.raises(ValueError, match="poll"):
        Poller("epoll")


@pytest.mark.parametrize("n_channels,n_loops",
                         [(4, 1), (4, 2), (4, 4), (5, 2), (7, 3), (8, 3)])
def test_channel_affinity_matches_jax(n_channels, n_loops):
    assert channel_affinity(n_channels, n_loops) == \
        jax_affinity(n_channels, n_loops)


def test_group_round_robin_threads_and_failure():
    runner = lambda loop, items: [(loop.index, x) for x in items]
    mk = lambda: EventLoopGroup([EventLoop(i, channels=(i,), runner=runner)
                                 for i in range(3)])
    g = mk()
    g.submit(list(range(7)))
    inline = g.run(threads=False)
    g2 = mk()
    g2.submit(list(range(7)))
    assert g2.run(threads=True) == inline == \
        [(0, 0), (0, 3), (0, 6), (1, 1), (1, 4), (2, 2), (2, 5)]

    def bad(loop, items):
        if loop.index == 1:
            raise RuntimeError("loop 1 died")
        return items
    g3 = EventLoopGroup([EventLoop(i, channels=(i,), runner=bad)
                         for i in range(2)])
    g3.submit([1, 2, 3])
    with pytest.raises(RuntimeError, match="loop 1 died"):
        g3.run(threads=True)
    assert g3.loops[0].results == [1, 3]
    with pytest.raises(ValueError, match="disjoint"):
        EventLoopGroup([EventLoop(0, channels=(0, 1)),
                        EventLoop(1, channels=(1,))])


def test_serve_config_validation():
    with pytest.raises(ValueError, match="poll"):
        ServeConfig(poll="epoll")
    with pytest.raises(ValueError, match="event_loops"):
        ServeConfig(event_loops=0)
    with pytest.raises(ValueError, match="channels"):
        ServeConfig(event_loops=8, comm=CommConfig(channels=4))
    with pytest.raises(ValueError, match="comm mode"):
        CommConfig(mode="ucx")


# -- CLI and the no-quiet-CPU rule -------------------------------------------


def test_cli_serves_on_cpu(capsys):
    rc = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "3", "--max-new", "2", "--batch", "2",
                         "--event-loops", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] 3 requests, 6 tokens" in out and "device=cpu" in out
    assert "loop 1: channels=(2, 3)" in out


def test_entry_points_raise_without_cuda(qwen, monkeypatch):
    _, tcfg, _, tp = qwen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine_group(tcfg, tp, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", ARCH, "--requests", "1"])
