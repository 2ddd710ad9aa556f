"""repro_torch's serving wire over a ring of peers, against the JAX
reference (f32, CPU): ``pipeline.emit_flat`` / ``raw_emit``, the
ring-aware serve step of every registered mode, the engine group and
the CLI at ring size 1 (a one-peer gloo group in this process), and
rings of 4 and 2 peers in gloo subprocesses (the port of
``tests/distributed/check_serving.py``).

Exactness: at ring size 1 a sum over the ring is the peer's own payload
and a gather its copy, so every mode's logits are ``torch.equal`` to
``gspmd``'s, and the JAX logits are held at the port's model tolerance
(atol = rtol = 1e-4: the frameworks sum in other orders). Over a ring,
prefill logits are computed locally and gathered (pure data movement),
so they are bitwise across modes at any ring size; decode logits are
summed over the ring: at 2 peers ``a + b == b + a`` exactly, but at 4
gloo's ring all-reduce starts each chunk's sum at a different peer, and
slicing moves an element's chunk, so the f32 sums may associate
differently: rtol 1e-6 with atol 1e-6 of the largest logit.

The moe expert exchange (``mixtral-8x7b-reduced``, 4 experts): every
mode but the pure local ``gspmd`` path runs the expert stage
expert-parallel through the ``all_to_all`` wire, at ring size 1 and on
gloo rings of 2 and 4 peers. An exchange is data movement and each
expert's GEMM runs on the same rows, so prefill logits and caches are
bitwise equal to the one-peer local path's; the ``all_to_all_single``
collectives are counted against the slice plan.
"""
import dataclasses
import itertools
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import CommConfig as JCommConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jax_config
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving import dispatch as jdispatch
from repro.serving import make_engine_group as jax_group
from repro_torch.configs.base import CommConfig, ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.backends import SyncContext, available_modes, pipeline
from repro_torch.core.channels import Ring
from repro_torch.launch import serve as serve_cli
from repro_torch.models import api
from repro_torch.models.common import tree_paths
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import Request, dispatch, make_engine_group

ARCH = "qwen2-0.5b-reduced"
TOL = dict(atol=1e-4, rtol=1e-4)
MODES = ("gspmd", "sockets", "vma", "hadronio", "hadronio_rs",
         "hadronio_overlap", "hadronio_overlap_rs")
SLICED = tuple(m for m in MODES if m.startswith("hadronio"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def qwen():
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, from_numpy_params(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _comm(mode, **kw):
    kw.setdefault("channels", 4)
    return CommConfig(mode=mode, slice_bytes=512, **kw)


def _jcomm(mode, **kw):
    kw.setdefault("channels", 4)
    return JCommConfig(mode=mode, slice_bytes=512, hierarchical=False, **kw)


def _inputs(vocab):
    """The fixed serve inputs of the reference's conformance suite: two
    rows of 6 and 8 tokens."""
    toks = np.zeros((2, 8), np.int32)
    toks[0, :6] = (np.arange(6) * 3) % vocab
    toks[1, :8] = (np.arange(8) * 5) % vocab
    return toks, np.array([6, 8], np.int32)


def _port_logits(tcfg, tp, comm, ring, affinity=None):
    step = dispatch.make_serve_step(tcfg, comm, ring=ring,
                                    channel_indices=affinity)
    toks, lens = _inputs(tcfg.vocab_size)
    lp, cache = step.prefill(tp, {"tokens": torch.as_tensor(toks).long(),
                                  "last_pos": torch.as_tensor(lens - 1)})
    cache = api.grow_cache(tcfg, cache, 32)
    ld, _ = step.decode(tp, cache, {"token": lp.argmax(-1),
                                    "pos": torch.as_tensor(lens).long()})
    return lp, ld


@pytest.fixture(scope="module")
def jax_logits(qwen):
    """(prefill, decode) logits of the JAX serve step per (mode,
    aggregate, flush); only the hadronio family reads the last two."""
    jcfg, _, jp, _ = qwen
    memo = {}

    def get(mode, aggregate="slice", flush="step"):
        if mode != "hadronio":
            aggregate, flush = "slice", "step"
        key = (mode, aggregate, flush)
        if key not in memo:
            step = jdispatch.make_serve_step(
                jcfg, _jcomm(mode, aggregate=aggregate, flush=flush))
            toks, lens = _inputs(jcfg.vocab_size)
            lp, cache = step.prefill(jp, {"tokens": jnp.asarray(toks),
                                          "last_pos": jnp.asarray(lens - 1)})
            cache = japi.grow_cache(jcfg, cache, 32)
            ld, _ = step.decode(jp, cache, {
                "token": jnp.argmax(lp, -1).astype(jnp.int32),
                "pos": jnp.asarray(lens)})
            memo[key] = (np.asarray(lp), np.asarray(ld))
        return memo[key]
    return get


# -- ring size 1: every mode, every schedule ---------------------------------


@pytest.mark.parametrize("aggregate,flush", list(itertools.product(
    CommConfig.AGGREGATES, CommConfig.FLUSHES)))
@pytest.mark.parametrize("mode", MODES)
def test_serve_logits_match_gspmd_and_jax(qwen, ring, jax_logits, mode,
                                          aggregate, flush):
    assert sorted(MODES) == list(available_modes())
    _, tcfg, _, tp = qwen
    ref_p, ref_d = _port_logits(tcfg, tp, _comm("gspmd"), ring)
    got_p, got_d = _port_logits(tcfg, tp, _comm(
        mode, aggregate=aggregate, flush=flush), ring)
    assert torch.equal(got_p, ref_p) and torch.equal(got_d, ref_d)
    want_p, want_d = jax_logits(mode, aggregate, flush)
    np.testing.assert_allclose(got_p.numpy(), want_p, **TOL)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)


@pytest.mark.parametrize("affinity", [(0, 1), (2, 3), (1,)])
def test_serve_logits_invariant_to_channel_affinity(qwen, ring, affinity):
    _, tcfg, _, tp = qwen
    ref_p, ref_d = _port_logits(tcfg, tp, _comm("hadronio"), ring)
    got_p, got_d = _port_logits(tcfg, tp, _comm("hadronio"), ring, affinity)
    assert torch.equal(got_p, ref_p) and torch.equal(got_d, ref_d)


def _count_collectives(monkeypatch):
    counts = {"all_reduce": 0, "all_gather_into_tensor": 0}
    for name in counts:
        fn = getattr(dist, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(dist, name, spy)
    return counts


@pytest.mark.parametrize("mode", MODES)
def test_decode_collectives_per_step(qwen, ring, mode, monkeypatch):
    """One decode step's logit reduction: one collective per ring slice
    under ``aggregate="slice"``, min(channels, slices) coalesced flushes
    under ``"channel"`` (the sliced wire of the hadronio family, the
    overlap modes flushing when ready); one whole-payload collective
    for sockets and vma; none for gspmd, whose step at ring size 1 with
    no affinity is the pure local path (the reference's
    ``test_serving_collectives_flow_through_staged_emission``)."""
    _, tcfg, _, tp = qwen
    n_channels = 2
    n_slices = dispatch.logit_payload_slices(tcfg, 2, _comm(mode))
    assert n_slices > n_channels
    want = {"slice": n_slices, "channel": n_channels} if mode in SLICED \
        else dict.fromkeys(("slice", "channel"),
                           0 if mode == "gspmd" else 1)
    toks, lens = _inputs(tcfg.vocab_size)
    cache = api.grow_cache(tcfg, api.prefill(
        tp, {"tokens": torch.as_tensor(toks).long(),
             "last_pos": torch.as_tensor(lens - 1)}, tcfg)[1], 32)
    dec = {"token": torch.tensor([1, 2]), "pos": torch.as_tensor(lens).long()}
    for aggregate, n in want.items():
        step = dispatch.make_serve_step(tcfg, _comm(
            mode, channels=n_channels, aggregate=aggregate), ring=ring)
        counts = _count_collectives(monkeypatch)
        step.decode(tp, {k: v.clone() for k, v in cache.items()}, dec)
        assert counts == {"all_reduce": n, "all_gather_into_tensor": 0}, \
            (aggregate, counts)
        monkeypatch.undo()


@pytest.mark.parametrize("arch,batch,slice_bytes", [
    ("qwen2-0.5b-reduced", 2, 512), ("qwen2-0.5b", 2, 4 * 1024 * 1024),
    ("rwkv6-7b", 8, 256 * 1024)])
def test_logit_payload_slices_matches_jax(arch, batch, slice_bytes):
    assert dispatch.logit_payload_slices(
        get_config(arch), batch, CommConfig(slice_bytes=slice_bytes)) == \
        jdispatch.logit_payload_slices(jax_config(arch), batch,
                                       JCommConfig(slice_bytes=slice_bytes))


@pytest.mark.parametrize("path", ["slice", "channel", "raw"])
@pytest.mark.parametrize("kind", ["all_reduce", "all_gather", "all_to_all"])
@pytest.mark.parametrize("n", [1, 511, 512, 513, 10_000])
def test_emit_exact_and_trimmed(ring, path, kind, n):
    """At ring size 1 the sliced and unsliced emissions return exactly
    the payload, padding trimmed, and leave the caller's tensor as it
    was (the all-reduce runs in place on a copy). 128-element slices:
    511..513 straddle one slice boundary and the ring's pad."""
    flat = torch.from_numpy(np.random.default_rng(n).normal(
        size=n).astype(np.float32))
    before = flat.clone()
    if path == "raw":
        ctx = SyncContext(_comm("sockets"), ring=ring)
        out = pipeline.raw_emit(flat, ctx, kind)
    else:
        ctx = SyncContext(_comm("hadronio", channels=3, aggregate=path,
                                flush="ready"), ring=ring)
        out = pipeline.emit_flat(flat, ctx, kind)
    assert out.shape == (n,) and torch.equal(out, before)
    assert torch.equal(flat, before)
    out.add_(1.0)                       # the result is not the caller's
    assert torch.equal(flat, before)


def test_sliced_wire_needs_a_ring(qwen):
    """No ring: the pure local path and ``raw_emit`` serve one peer; the
    sliced path raises."""
    _, tcfg, _, tp = qwen
    flat = torch.ones(300)
    ctx = SyncContext(_comm("hadronio"))
    assert pipeline.raw_emit(flat, ctx, "all_gather") is flat
    with pytest.raises(ValueError, match="ring"):
        pipeline.emit_flat(flat, ctx, "all_reduce")
    with pytest.raises(ValueError, match="ring"):
        _port_logits(tcfg, tp, _comm("hadronio"), None)
    with pytest.raises(ValueError, match="ring"):
        pipeline.raw_emit(flat, SyncContext(_comm("sockets"), world_size=2),
                          "all_reduce")
    with pytest.raises(ValueError, match="ring"):
        pipeline.emit_flat(flat, ctx, "all_to_all")
    with pytest.raises(ValueError, match="multiple"):   # 250 per 1001 B
        pipeline.emit_flat(torch.ones(10_001), SyncContext(CommConfig(
            mode="hadronio", slice_bytes=1001)), "all_reduce")


@pytest.mark.parametrize("mode", MODES)
def test_serving_rejects_wire_compression(mode):
    with pytest.raises(ValueError, match="compress"):
        dispatch.validate_serve_comm(CommConfig(mode=mode, compress="bf16"))
    with pytest.raises(ValueError, match="compress"):
        dispatch.make_serve_step(get_config(ARCH), CommConfig(
            mode=mode, compress="bf16"))


# -- engine groups, the recurrent families, the CLI --------------------------


def _group_requests(vocab):
    rng = np.random.default_rng(11)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(4, 16))), 3)
            for i in range(6)]


@pytest.fixture(scope="module")
def jax_group_tokens(qwen):
    jcfg, tcfg, jp, _ = qwen
    g = jax_group(jcfg, jp, JServeConfig(
        event_loops=1, poll="busy", max_batch=2, max_len=48,
        comm=_jcomm("hadronio")))
    g.submit([JRequest(u, p, max_new=m)
              for u, p, m in _group_requests(tcfg.vocab_size)])
    return [tuple(r.tokens.tolist())
            for r in sorted(g.run(threads=False), key=lambda r: r.uid)]


@pytest.mark.parametrize("event_loops", [1, 2, 4])
def test_hadronio_group_tokens_match_jax(qwen, ring, jax_group_tokens,
                                         event_loops):
    """Greedy tokens of the hadronio group for 1, 2 and 4 event loops
    (threaded, each loop on its own channel communicators) equal the JAX
    group's."""
    _, tcfg, _, tp = qwen
    g = make_engine_group(tcfg, tp, ServeConfig(
        event_loops=event_loops, poll="busy", max_batch=2, max_len=48,
        comm=_comm("hadronio")), device="cpu", ring=ring)
    g.submit([Request(u, p, max_new=m)
              for u, p, m in _group_requests(tcfg.vocab_size)])
    res = sorted(g.run(threads=event_loops > 1), key=lambda r: r.uid)
    assert [tuple(r.tokens.tolist()) for r in res] == jax_group_tokens
    # 6 requests on 2 slots a loop: admission runs unless 4 loops take
    # at most 2 each
    assert (sum(l.engine.admit_prefills for l in g.loops) > 0) == \
        (event_loops < 4)


@pytest.mark.parametrize("arch,replace", [
    ("rwkv6-7b-reduced", {}),
    ("recurrentgemma-9b-reduced", {"num_layers": 8}),
    ("recurrentgemma-9b-reduced", {"num_layers": 8,
                                   "param_dtype": "bfloat16",
                                   "compute_dtype": "bfloat16"})],
    ids=["rwkv6", "recurrentgemma-tail", "recurrentgemma-tail-bf16"])
def test_recurrent_families_serve_through_hadronio(ring, arch, replace):
    """rwkv6's state and recurrentgemma's mixed tree (``groups`` with
    batch at 1, ``tail*`` at 0; bf16 leaves cross the f32 wire and back
    exactly) through the sliced gathering write and TP head: the logits
    equal gspmd's bit for bit."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), **replace)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 9)))
    out = {}
    for mode in ("gspmd", "hadronio"):
        step = dispatch.make_serve_step(cfg, _comm(mode, aggregate="channel"),
                                        ring=ring, channel_indices=(1, 2))
        lp, cache = step.prefill(params, {"tokens": toks})
        ld, _ = step.decode(params, api.grow_cache(cfg, cache, 16), {
            "token": lp.argmax(-1), "pos": torch.tensor([9, 9])})
        out[mode] = (lp, ld)
    for got, want in zip(out["hadronio"], out["gspmd"]):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("arch", ["whisper-tiny-reduced",
                                  "llava-next-mistral-7b-reduced"])
def test_encdec_vlm_serve_through_hadronio(ring, arch):
    """whisper's nested cache (``self.k``, ``self.v``, ``cross_k``,
    ``cross_v``) and llava's prefixed KV pages through the sliced
    gathering write and TP head, the prefill batch carrying frames or
    patches: logits and every cache leaf equal gspmd's bit for bit, and
    the tree comes back nested."""
    cfg = get_config(arch)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, lens = _inputs(cfg.vocab_size)
    emb = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, cfg.num_frames if cfg.family == "encdec"
              else cfg.num_patches, cfg.d_model)).astype(np.float32))
    batch = {"tokens": torch.as_tensor(toks).long(),
             "last_pos": torch.as_tensor(lens - 1).long(),
             "frames" if cfg.family == "encdec" else "patches": emb}
    out = {}
    for mode in ("gspmd", "hadronio"):
        step = dispatch.make_serve_step(cfg, _comm(mode, aggregate="channel"),
                                        ring=ring, channel_indices=(1, 2))
        lp, cache = step.prefill(params, batch)
        pre = [t.clone() for _, t in tree_paths(cache)]
        ld, _ = step.decode(params, api.grow_cache(cfg, cache, 16), {
            "token": lp.argmax(-1), "pos": torch.as_tensor(lens).long()})
        out[mode] = (cache, [lp, ld] + pre)
    assert [p for p, _ in tree_paths(out["hadronio"][0])] == \
        [p for p, _ in tree_paths(out["gspmd"][0])]
    if cfg.family == "encdec":
        assert set(out["hadronio"][0]["self"]) == {"k", "v"}
    for got, want in zip(out["hadronio"][1], out["gspmd"][1]):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_cli_serves_through_hadronio(capsys):
    rc = serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "3", "--max-new", "2", "--batch", "2",
                         "--event-loops", "2", "--comm-mode", "hadronio",
                         "--aggregate", "channel", "--flush", "ready"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] 3 requests, 6 tokens" in out and "comm=hadronio" in out
    assert "ring=1" in out and "loop 1: channels=(2, 3)" in out


# -- rings of 4 and 2 peers (gloo subprocesses) ------------------------------

_WORKER = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channels import Ring
    from repro_torch.models import api
    from repro_torch.models.convert import from_numpy_params
    from repro_torch.serving import (DecodeEngine, Request, dispatch,
                                     make_engine_group)

    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        ring = Ring(channels=4)
        with open(inp, "rb") as f:
            data = pickle.load(f)
        cfg = get_config("qwen2-0.5b-reduced")
        params = from_numpy_params(data["params"], "cpu")
        comm = lambda mode, **kw: CommConfig(mode=mode, slice_bytes=512,
                                             channels=4, **kw)
        res = {}

        def logits(mode, affinity=None, **kw):
            step = dispatch.make_serve_step(cfg, comm(mode, **kw), ring=ring,
                                            channel_indices=affinity)
            assert step.n_shards == world
            toks = np.zeros((4, 8), np.int64)      # 4 rows, mixed lengths
            lens = np.array([5, 6, 7, 5])
            for r in range(4):
                toks[r, :lens[r]] = (np.arange(lens[r]) * (r + 2)) % 256
            lp, cache = step.prefill(params, {
                "tokens": torch.as_tensor(toks),
                "last_pos": torch.as_tensor(lens - 1)})
            cache = api.grow_cache(cfg, cache, 32)
            ld, _ = step.decode(params, cache, {
                "token": lp.argmax(-1), "pos": torch.as_tensor(lens)})
            return lp.numpy(), ld.numpy()

        for mode in ("gspmd", "sockets", "vma", "hadronio", "hadronio_rs",
                     "hadronio_overlap_rs"):
            res["logits", mode] = logits(mode)
        res["logits", "hadronio(1, 3)"] = logits("hadronio", (1, 3))
        res["logits", "hadronio/channel/ready"] = logits(
            "hadronio", aggregate="channel", flush="ready")
        reqs = [Request(u, p, max_new=m) for u, p, m in data["reqs"]]

        def group_tokens(cfg, params, mode, event_loops):
            serve = ServeConfig(event_loops=event_loops, poll="busy",
                                max_batch=2, max_len=48, comm=comm(mode))
            g = make_engine_group(cfg, params, serve, device="cpu",
                                  ring=ring)
            g.submit(reqs)
            got = sorted(g.run(threads=False), key=lambda r: r.uid)
            return [tuple(r.tokens.tolist()) for r in got]

        if world == 4:
            for mode, el in (("hadronio", 1), ("hadronio", 2), ("gspmd", 1),
                             ("sockets", 1), ("vma", 1)):
                res["tokens", mode, el] = group_tokens(cfg, params, mode, el)
            eng = DecodeEngine(cfg, params, max_batch=2, max_len=48,
                               serve=ServeConfig(max_batch=2, max_len=48,
                                                 comm=comm("hadronio")),
                               device="cpu", ring=ring)
            res["solo", 4] = tuple(eng.generate([reqs[4]])[0].tokens.tolist())
        else:
            for arch, kw in data["families"]:
                rcfg = dataclasses.replace(get_config(arch), **kw)
                rp = api.init(torch.Generator().manual_seed(0), rcfg,
                              device="cpu")
                res["tokens", arch] = group_tokens(rcfg, rp, "hadronio", 2)
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')


def _ring_run(tmp_path, world, data, worker=None):
    """Run ``worker`` (default the serving worker above) on ``world``
    gloo ranks; every rank's results."""
    inp = tmp_path / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker or _WORKER, str(r), str(world),
         str(tmp_path / "store"), str(inp), str(tmp_path / f"out{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    for o in outs[1:]:                 # every peer holds the same results
        assert o.keys() == outs[0].keys()
        for k, v in o.items():
            if k[0] == "logits":
                for a, b in zip(v, outs[0][k]):
                    np.testing.assert_array_equal(a, b)
            else:
                assert v == outs[0][k], k
    return outs[0]


def _ring_data(qwen):
    jcfg, tcfg, jp, _ = qwen
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, tcfg.vocab_size,
                             size=int(rng.integers(4, 14))), 3)
            for i in range(5)]
    return {"params": jax.tree.map(np.asarray, jp), "reqs": reqs}


def test_ring_of_four_peers(qwen, tmp_path):
    """The reference's four-device serving check on four gloo peers:
    prefill logits bitwise across modes (the ZeRO-1 modes too) and an
    affinity; decode logits within rtol 1e-6, atol 1e-6 of the largest
    logit (gloo's order), and the ZeRO-1 modes' bitwise equal to
    hadronio's;
    group greedy tokens equal across modes and 1 and 2 event loops, with
    max_batch 2 below the ring size (padded rows, admission), and equal
    to the JAX one-device group's; an admitted request equal to its solo
    run."""
    jcfg, tcfg, jp, _ = qwen
    data = _ring_data(qwen)
    res = _ring_run(tmp_path, 4, data)
    ref_p, ref_d = res["logits", "gspmd"]
    assert ref_p.shape == (4, tcfg.vocab_size)
    worst = 0.0
    for key in ("sockets", "vma", "hadronio", "hadronio_rs",
                "hadronio_overlap_rs", "hadronio(1, 3)",
                "hadronio/channel/ready"):
        got_p, got_d = res["logits", key]
        np.testing.assert_array_equal(got_p, ref_p)
        np.testing.assert_allclose(got_d, ref_d, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref_d).max())
        worst = max(worst, float(np.abs(got_d - ref_d).max()))
    print(f"4 peers: largest decode-logit difference across modes {worst:.3e}"
          f" (max |logit| {np.abs(ref_d).max():.3e})")
    for key in ("hadronio_rs", "hadronio_overlap_rs"):
        # the ZeRO-1 modes serve through hadronio's sliced wire: the same
        # slices, summed in the same order, bit for bit
        np.testing.assert_array_equal(res["logits", key][1],
                                      res["logits", "hadronio"][1])
    toks = {k[1:]: v for k, v in res.items() if k[0] == "tokens"}
    first = toks["hadronio", 1]
    assert all(t == first for t in toks.values()), toks
    g = jax_group(jcfg, jp, JServeConfig(event_loops=1, poll="busy",
                                         max_batch=2, max_len=48,
                                         comm=JCommConfig(mode="gspmd")))
    g.submit([JRequest(u, p, max_new=m) for u, p, m in data["reqs"]])
    want = [tuple(r.tokens.tolist())
            for r in sorted(g.run(threads=False), key=lambda r: r.uid)]
    assert first == want
    assert res["solo", 4] == first[4]


FAMILIES = [("rwkv6-7b-reduced", {}),
            ("recurrentgemma-9b-reduced", {"num_layers": 8}),
            ("whisper-tiny-reduced", {}),
            ("llava-next-mistral-7b-reduced", {})]


def test_ring_of_two_peers(qwen, tmp_path):
    """Two peers: decode logits bitwise across modes (a + b == b + a);
    rwkv6, recurrentgemma (with its tail entries, batch at axis 0),
    whisper (its nested cache, the frames split by rows) and llava (the
    patch prefix) serve through the hadronio wire with the tokens of one
    peer."""
    data = dict(_ring_data(qwen), families=FAMILIES)
    res = _ring_run(tmp_path, 2, data)
    ref_p, ref_d = res["logits", "gspmd"]
    for key in ("sockets", "vma", "hadronio", "hadronio(1, 3)",
                "hadronio/channel/ready"):
        got_p, got_d = res["logits", key]
        np.testing.assert_array_equal(got_p, ref_p)
        np.testing.assert_array_equal(got_d, ref_d)
    for arch, kw in FAMILIES:
        cfg = dataclasses.replace(get_config(arch), **kw)
        params = api.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
        g = make_engine_group(cfg, params, ServeConfig(
            event_loops=2, poll="busy", max_batch=2, max_len=48,
            comm=CommConfig(mode="gspmd")), device="cpu")
        g.submit([Request(u, p, max_new=m) for u, p, m in data["reqs"]])
        want = [tuple(r.tokens.tolist())
                for r in sorted(g.run(threads=False), key=lambda r: r.uid)]
        assert res["tokens", arch] == want, arch


# -- the moe expert exchange (all_to_all) -------------------------------------

MOE = "mixtral-8x7b-reduced"
MOE_SLICE = 4096
MOE_MODES = (("gspmd", "slice"), ("sockets", "slice"), ("vma", "slice"),
             ("hadronio", "slice"), ("hadronio", "channel"),
             ("hadronio_overlap", "slice"))


@pytest.fixture(scope="module")
def mixtral():
    jcfg, tcfg = jax_config(MOE), get_config(MOE)
    jp = japi.init(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, from_numpy_params(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _moe_comm(mode, aggregate="slice"):
    return CommConfig(mode=mode, slice_bytes=MOE_SLICE, channels=4,
                      aggregate=aggregate)


def _exchanges(cfg, mode, aggregate, batch, seq, world):
    """The ``all_to_all_single`` calls one serve call makes: two
    exchanges per moe layer, each one collective unsliced, one per ring
    slice (``aggregate="slice"``) or per channel used (``"channel"``)
    sliced."""
    comm = _moe_comm(mode, aggregate)
    n = dispatch.expert_exchange_slices(cfg, batch, seq, comm, world)
    per = 1 if mode in ("gspmd", "sockets", "vma") else \
        n if aggregate == "slice" else min(comm.channels, n)
    return 2 * cfg.num_layers * per


@pytest.mark.parametrize("mode,aggregate", MOE_MODES[1:])
def test_moe_expert_exchange_matches_local_and_jax(mixtral, ring, mode,
                                                   aggregate, monkeypatch):
    """Ring size 1: every mode but the pure local gspmd path runs the
    expert stage through the exchange; the logits are bitwise the local
    path's and within TOL of the JAX serve step's (which exchanges
    too), and the exchanges are counted."""
    jcfg, tcfg, jp, tp = mixtral
    ref_p, ref_d = _port_logits(tcfg, tp, _moe_comm("gspmd"), None)
    calls = []
    real = dist.all_to_all_single
    monkeypatch.setattr(dist, "all_to_all_single",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got_p, got_d = _port_logits(tcfg, tp, _moe_comm(mode, aggregate), ring)
    assert torch.equal(got_p, ref_p) and torch.equal(got_d, ref_d)
    assert len(calls) == sum(_exchanges(tcfg, mode, aggregate, 2, s, 1)
                             for s in (8, 1))
    step = jdispatch.make_serve_step(jcfg, JCommConfig(
        mode=mode, slice_bytes=MOE_SLICE, channels=4, aggregate=aggregate,
        hierarchical=False))
    toks, lens = _inputs(jcfg.vocab_size)
    lp, cache = step.prefill(jp, {"tokens": jnp.asarray(toks),
                                  "last_pos": jnp.asarray(lens - 1)})
    ld, _ = step.decode(jp, japi.grow_cache(jcfg, cache, 32), {
        "token": jnp.argmax(lp, -1).astype(jnp.int32),
        "pos": jnp.asarray(lens)})
    np.testing.assert_allclose(got_p.numpy(), np.asarray(lp), **TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ld), **TOL)


def test_moe_group_tokens_match_jax(mixtral, ring):
    """Greedy tokens of the hadronio group (2 threaded loops, the
    expert exchange on each loop's channels) equal the JAX group's;
    prompts plus new tokens run past the reduced window of 16."""
    jcfg, tcfg, jp, tp = mixtral
    reqs = _group_requests(tcfg.vocab_size)
    assert max(len(p) + m for _, p, m in reqs) > tcfg.sliding_window
    g = jax_group(jcfg, jp, JServeConfig(
        event_loops=1, poll="busy", max_batch=2, max_len=48,
        comm=_jcomm("hadronio")))
    g.submit([JRequest(u, p, max_new=m) for u, p, m in reqs])
    want = [tuple(r.tokens.tolist())
            for r in sorted(g.run(threads=False), key=lambda r: r.uid)]
    tg = make_engine_group(tcfg, tp, ServeConfig(
        event_loops=2, poll="busy", max_batch=2, max_len=48,
        comm=_comm("hadronio")), device="cpu", ring=ring)
    tg.submit([Request(u, p, max_new=m) for u, p, m in reqs])
    got = sorted(tg.run(threads=True), key=lambda r: r.uid)
    assert [tuple(r.tokens.tolist()) for r in got] == want


def test_cli_serves_moe_through_hadronio(capsys):
    rc = serve_cli.main(["--arch", MOE, "--device", "cpu", "--requests",
                         "3", "--max-new", "2", "--batch", "2",
                         "--comm-mode", "hadronio"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve] 3 requests, 6 tokens" in out and "comm=hadronio" in out


_MOE_WORKER = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channels import Ring
    from repro_torch.models import api
    from repro_torch.models.convert import from_numpy_params
    from repro_torch.serving import dispatch

    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    *sys.argv[3:])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        ring = Ring(channels=4)
        with open(inp, "rb") as f:
            data = pickle.load(f)
        cfg = get_config("mixtral-8x7b-reduced")
        params = from_numpy_params(data["params"], "cpu")
        calls = [0]
        real = dist.all_to_all_single

        def counted(*a, **kw):
            calls[0] += 1
            return real(*a, **kw)
        dist.all_to_all_single = counted
        as_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
        res = {}
        for mode, aggregate in data["modes"]:
            step = dispatch.make_serve_step(cfg, CommConfig(
                mode=mode, slice_bytes=data["slice_bytes"], channels=4,
                aggregate=aggregate), ring=ring)
            assert step.n_shards == world
            calls[0] = 0
            lp, cache = step.prefill(params, as_t(data["prefill"]))
            n_prefill = calls[0]
            kv = [cache[k].clone().numpy() for k in ("k", "v")]
            calls[0] = 0
            ld, _ = step.decode(params, api.grow_cache(cfg, cache, 32),
                                as_t(data["decode"]))
            res["logits", mode, aggregate] = (lp.numpy(), ld.numpy(), *kv)
            res["exchanges", mode, aggregate] = (n_prefill, calls[0])
        with open(out, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
''')


@pytest.mark.parametrize("world", [2, 4])
def test_moe_rings_exchange_experts(mixtral, tmp_path, world):
    """gloo rings of 2 and 4 peers, 4 request rows, every mode (gspmd
    too: past one peer it is not the pure local path): prefill logits
    and the gathered KV cache are bitwise the local path's on each
    peer's rows (each peer prefills its rows, its experts' inputs come
    from every peer); decode logits, summed over the ring by the TP
    head, are within TOL of the local path's, bitwise across modes at 2
    peers and within rtol 1e-6 (atol 1e-6 of the largest logit) at 4
    (gloo's order); the exchanges are as the slice plan predicts (each
    peer's prefill carries its 4 / world rows, decode all 4)."""
    _, tcfg, jp, tp = mixtral
    toks = np.zeros((4, 8), np.int64)
    lens = np.array([5, 8, 7, 6])
    for r in range(4):
        toks[r, :lens[r]] = (np.arange(lens[r]) * (r + 3)) % 256
    pre = {"tokens": toks, "last_pos": lens - 1}
    # the local expert stage on each peer's rows, gathered (a lone row's
    # LM head is a matrix-vector product, which may round otherwise than
    # the 4-row product)
    bs = 4 // world
    parts = [api.prefill(tp, {k: torch.as_tensor(v[r:r + bs])
                              for k, v in pre.items()}, tcfg)
             for r in range(0, 4, bs)]
    lp = torch.cat([l for l, _ in parts])
    cache = {k: torch.cat([c[k] for _, c in parts], dim=1)
             for k in ("k", "v")}
    dec = {"token": lp.argmax(-1).numpy(), "pos": lens}
    ld, _ = api.decode_step(tp, api.grow_cache(tcfg, {
        k: v.clone() for k, v in cache.items()}, 32), {
        k: torch.as_tensor(v) for k, v in dec.items()}, tcfg)
    res = _ring_run(tmp_path, world, {
        "params": jax.tree.map(np.asarray, jp), "modes": MOE_MODES,
        "slice_bytes": MOE_SLICE, "prefill": pre, "decode": dec},
        _MOE_WORKER)
    ref_d = res["logits", "gspmd", "slice"][1]
    for mode, aggregate in MOE_MODES:
        got_p, got_d, got_k, got_v = res["logits", mode, aggregate]
        np.testing.assert_array_equal(got_p, lp.numpy())
        np.testing.assert_array_equal(got_k, cache["k"].numpy())
        np.testing.assert_array_equal(got_v, cache["v"].numpy())
        np.testing.assert_allclose(got_d, ld.numpy(), **TOL)
        if world == 2:
            np.testing.assert_array_equal(got_d, ref_d)
        else:
            np.testing.assert_allclose(got_d, ref_d, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref_d).max())
        assert res["exchanges", mode, aggregate] == tuple(
            _exchanges(tcfg, mode, aggregate, b, s, world)
            for b, s in ((4 // world, 8), (4, 1))), (mode, aggregate)
