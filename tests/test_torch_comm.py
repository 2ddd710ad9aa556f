"""repro_torch comm core against the JAX reference: ring-buffer and pack
plans, the flush schedules, the staged emission, ``reduce_slices`` at
ring size 1, and a two-peer gloo ring in subprocesses for
``tac.sync_grads`` over every aggregate x flush x compress x pack
combination of ``hadronio``, beside ``sockets`` (no codec) and ``vma``
(no codec, and bf16 with either pack stage).

Exactness: plans and schedules are integers and must be equal. At ring
size 1 a sum over the ring is the peer's own buffer, so ``none`` and
``bf16`` are bitwise; ``int8_ef`` is compared at allclose (1e-6): the
quantizer divides by a per-slice scale that the two frameworks may
compute through different reciprocal paths. On two peers a sum of two
f32 values rounds the same in either order, so ``none`` is bitwise
against numpy; the bf16 wire sums bf16 values, held at two bf16 ulps
(2^-7) of the largest gradient; int8 at one quantization step per peer.
"""
import itertools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import compat as jcompat
from repro.configs.base import CommConfig as JCommConfig
from repro.configs.registry import get_config as jax_config
from repro.core import aggregation as jagg
from repro.core import flush_scheduler as jflush
from repro.core import ring_buffer as jring
from repro.core import selector as jsel
from repro.core.backends import pipeline as jpipeline
from repro.core.backends.base import SyncContext as JSyncContext
from repro.launch.mesh import make_mesh
from repro.models import api as japi
from repro_torch.configs.base import CommConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import aggregation as agg
from repro_torch.core import flush_scheduler as flush
from repro_torch.core import ring_buffer, selector
from repro_torch.core.backends import SyncContext, pipeline
from repro_torch.core.channels import Ring
from repro_torch.models import api

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


# -- plans and schedules -----------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-0.5b-reduced"])
@pytest.mark.parametrize("slice_bytes", [4 * 1024 * 1024, 64 * 1024, 1000])
def test_pack_plan_matches_jax(arch, slice_bytes):
    jplan = jagg.make_plan(japi.abstract(jax_config(arch)),
                           JCommConfig(slice_bytes=slice_bytes))
    plan = agg.make_plan(api.specs(get_config(arch)),
                         CommConfig(slice_bytes=slice_bytes))
    for f in ("offsets", "shapes", "total_elems", "padded_elems",
              "slice_elems", "n_slices"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.slice_plan.__dict__ == jplan.slice_plan.__dict__
    if arch == "qwen2-0.5b" and slice_bytes == 4 * 1024 * 1024:
        # the capacity-clamped plan of the card run
        assert (plan.n_slices, plan.slice_elems) == (64, 7_719_424)
        assert plan.total_elems == 494_032_768


@pytest.mark.parametrize("total", [1, 511, 4096, 10 ** 6, 2 * 10 ** 9])
@pytest.mark.parametrize("slice_bytes,cap", [(4096, 4096), (4096, 65536),
                                             (1000, 1 << 20)])
def test_plan_slices_matches_jax(total, slice_bytes, cap):
    kw = dict(slice_bytes=slice_bytes, ring_capacity_bytes=cap)
    assert ring_buffer.plan_slices(total, CommConfig(**kw)).__dict__ == \
        jring.plan_slices(total, JCommConfig(**kw)).__dict__


def test_flush_plans_and_groups_match_jax():
    for n, c in itertools.product(range(1, 14), range(1, 7)):
        for mode in ("step", "ready"):
            assert flush.make_flush_plan(n, c, mode) == \
                jflush.make_flush_plan(n, c, mode), (n, c, mode)
        for rev in (False, True):
            assert selector.ready_groups(n, c, rev) == \
                jsel.ready_groups(n, c, rev)
    plan = flush.make_flush_plan(8, 3, "ready")
    assert plan.contiguous and plan.readiness_depth == 2
    with pytest.raises(ValueError, match="flush"):
        flush.make_flush_plan(4, 2, "eventually")


@pytest.mark.parametrize("bad", [dict(channels=0), dict(compress="fp8"),
                                 dict(pack="triton"), dict(aggregate="x"),
                                 dict(flush="x")])
def test_comm_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        JCommConfig(**bad)
    with pytest.raises(ValueError, match=next(iter(bad))):
        CommConfig(**bad)


def test_pack_roundtrip_keeps_jax_leaf_order():
    cfg = get_config("qwen2-0.5b-reduced")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    plan = agg.make_plan(params, CommConfig(slice_bytes=4096))
    flat = agg.pack(params, plan)
    assert flat.shape == (plan.padded_elems,) and flat.dtype == torch.float32
    assert not flat[plan.total_elems:].any()
    # the reference's leaf order: dict keys sorted at every level
    start = plan.offsets[0][0]
    assert torch.equal(flat[start:start + 256 * 64],
                       params["embed"]["tok"].reshape(-1))
    back = agg.unpack(agg.from_slices(agg.as_slices(flat, plan), plan),
                      plan, params)
    for k, v in params["layers"]["attn"].items():
        assert torch.equal(back["layers"]["attn"][k], v), k


# -- the staged emission ---------------------------------------------------


def _ctx(ring, **kw):
    return SyncContext(CommConfig(mode="hadronio", **kw), ring=ring)


@pytest.mark.parametrize("aggregate,flush_,want", [
    ("slice", "step", [[0], [1], [2], [3]]),
    ("slice", "ready", [[0], [1], [2], [3]]),
    ("channel", "step", [[], [], [], []]),
    ("channel", "ready", [[], [0, 1], [], [2, 3]])])
def test_staged_emission_schedule(ring, aggregate, flush_, want):
    """Which stage call flushes what (the reference's
    test_step_schedule_defers_all_flushes), and every schedule returns
    the items' sums (at ring size 1: the items themselves)."""
    rng = np.random.default_rng(0)
    items = [torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
             for _ in range(4)]
    orig = [x.clone() for x in items]
    st = pipeline.begin_emission(_ctx(ring, channels=2, aggregate=aggregate,
                                      flush=flush_), 4)
    assert [pipeline.stage_slices(st, i, x)
            for i, x in enumerate(items)] == want
    outs = pipeline.finish_emission(st)
    for a, b in zip(outs, orig):
        assert torch.equal(a, b)


def test_finish_refuses_incomplete_emission(ring):
    st = pipeline.begin_emission(_ctx(ring, channels=2, aggregate="channel",
                                      flush="ready"), 3)
    pipeline.stage_slices(st, 0, torch.zeros(8))
    with pytest.raises(RuntimeError, match="incomplete"):
        pipeline.finish_emission(st)
    with pytest.raises(ValueError, match="unknown emission kind"):
        pipeline.begin_emission(_ctx(ring), 2, "all_to_some")


def _jax_reduce(comm: JCommConfig, slices: np.ndarray, ef: np.ndarray):
    mesh = make_mesh((1,), ("data",))

    def body(x, e):
        ctx = JSyncContext.resolve(comm, ("data",), None, e)
        red, new_ef = jpipeline.reduce_slices(x, ctx)
        return red, (jnp.zeros_like(x) if new_ef is None else new_ef)

    f = jax.jit(jcompat.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                                  out_specs=(P(), P())))
    red, new_ef = f(jnp.asarray(slices), jnp.asarray(ef))
    return np.asarray(red), np.asarray(new_ef)


@pytest.mark.parametrize("compress", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("pack", ["jnp", "pallas"])
@pytest.mark.parametrize("aggregate", ["slice", "channel"])
def test_reduce_slices_matches_jax_at_ring_size_1(ring, compress, pack,
                                                  aggregate):
    rng = np.random.default_rng(1)
    slices = rng.normal(size=(5, 1024)).astype(np.float32)
    ef = (rng.normal(size=(5, 1024)) * 1e-3).astype(np.float32)
    kw = dict(mode="hadronio", compress=compress, pack=pack, channels=3,
              aggregate=aggregate)
    jred, jef = _jax_reduce(JCommConfig(hierarchical=False, **kw), slices, ef)
    ctx = SyncContext(CommConfig(**kw), ring=ring,
                      ef=torch.from_numpy(ef))
    red, new_ef = pipeline.reduce_slices(torch.from_numpy(slices.copy()),
                                         ctx)
    assert red.shape == (5, 1024) and red.dtype == torch.float32
    if compress == "none":
        assert new_ef is None
        new_ef = torch.zeros(5, 1024)
    if compress == "int8_ef":
        np.testing.assert_allclose(red.numpy(), jred, atol=1e-6, rtol=0)
        np.testing.assert_allclose(new_ef.numpy(), jef, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(red.numpy(), jred)
        np.testing.assert_array_equal(new_ef.numpy(), jef)


def test_pack_impl_has_no_fallback(monkeypatch):
    """``pallas`` reaches the kernel wrappers and ``jnp`` their plain
    versions, each and nothing else (the reference would degrade
    ``pallas`` to ``jnp`` without a Pallas toolchain); on a CPU tensor
    the wrapper then runs the plain version, on a CUDA one the kernel."""
    from repro_torch.kernels import ops, ref
    calls = []
    for mod, name in itertools.product((ops, ref),
                                       ("pack_slices", "unpack_slices")):
        fn = getattr(mod, name)
        spy = (lambda fn, tag: lambda *a, **k: (calls.append(tag),
                                                fn(*a, **k))[1])(
            fn, f"{mod.__name__.rsplit('.', 1)[1]}.{name}")
        monkeypatch.setattr(mod, name, spy)
    x = torch.randn(3, 512)
    for pack in ("pallas", "jnp"):
        calls.clear()
        comm = CommConfig(mode="hadronio", compress="bf16", pack=pack)
        wire, new_ef, scale = pipeline.pack_wire(x, torch.zeros_like(x), comm)
        assert wire.dtype == torch.bfloat16 and scale is None
        pipeline.unpack_wire(wire, comm)
        lib = "ops" if pack == "pallas" else "ref"
        # the wrapper hands a CPU tensor on to its plain version
        want = [f"{lib}.pack_slices", f"{lib}.unpack_slices"]
        if pack == "pallas":
            want = [want[0], "ref.pack_slices", want[1], "ref.unpack_slices"]
        assert calls == want, (pack, calls)


# -- a two-peer gloo ring --------------------------------------------------

_WORKER = textwrap.dedent('''
    import itertools, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import tac
    from repro_torch.core.channels import Ring

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    try:
        ring = Ring(channels=3)
        rng = np.random.default_rng(rank)
        grads = {"b": {"w": rng.normal(size=(37, 11)).astype(np.float32)},
                 "a": rng.normal(size=(1000,)).astype(np.float32)}
        res = {}
        combos = [("hadronio",) + c for c in itertools.product(
            ("slice", "channel"), ("step", "ready"),
            ("none", "bf16", "int8_ef"), ("jnp", "pallas"))]
        combos += [("sockets", "slice", "step", "none", "jnp")]
        combos += [("vma", "slice", "step", comp, pack) for comp, pack in
                   (("none", "jnp"), ("bf16", "jnp"), ("bf16", "pallas"))]
        for mode, agg_, fl, comp, pack in combos:
            comm = CommConfig(mode=mode, slice_bytes=1024, channels=3,
                              aggregate=agg_, flush=fl, compress=comp,
                              pack=pack)
            # fresh copies: sockets sums the caller's tensors in place
            t = {"b": {"w": torch.tensor(grads["b"]["w"])},
                 "a": torch.tensor(grads["a"])}
            ef = None if comp == "none" else torch.zeros(3, 512)
            r = tac.sync_grads(t, comm, ring=ring, ef=ef)
            res["/".join((mode, agg_, fl, comp, pack))] = np.concatenate(
                [r.grads["a"].numpy(), r.grads["b"]["w"].numpy().ravel()])
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()
''')


def test_two_peer_ring_sums_every_combination(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    grads = []
    for r in range(2):
        rng = np.random.default_rng(r)
        w = rng.normal(size=(37, 11)).astype(np.float32)
        a = rng.normal(size=(1000,)).astype(np.float32)
        grads.append(np.concatenate([a, w.ravel()]))
    want = grads[0] + grads[1]
    assert len(outs[0]) == 2 * 2 * 3 * 2 + 1 + 3
    by_codec: dict = {}
    for key, got in outs[0].items():
        np.testing.assert_array_equal(got, outs[1][key])   # replicated
        codec = key.split("/")[3]
        by_codec.setdefault(codec, []).append(got)
        if codec == "none":
            np.testing.assert_array_equal(got, want)
        elif codec == "bf16":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 ** -7 * np.abs(want).max())
        else:
            step = sum(np.abs(g).max() / 127 for g in grads)
            np.testing.assert_allclose(got, want, rtol=0, atol=step)
    for codec, results in by_codec.items():     # mode/schedule-invariant
        for got in results[1:]:
            np.testing.assert_array_equal(got, results[0])
