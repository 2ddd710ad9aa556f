"""repro_torch's analysis layer (``launch/hlo_analysis.py``) against the
JAX reference's, on the CPU:

* ARITHMETIC — ``model_flops``, ``analytic_hbm_bytes``,
  ``cell_skip_reason`` and ``cells_for`` equal the reference's for every
  arch id and its ``-reduced`` variant over every shape (rel 1e-12);
  ``roofline_terms`` times the port's peaks equals the reference's terms
  times its peaks, and ``tests/test_hlo_analysis.py``'s bottleneck cases
  hold at the card's figures; ``input_specs`` has the reference's keys
  and shapes.
* THE RECORDER — for every hadronio-family mode x {slice, channel}, on
  ``tests/test_backend_conformance.py``'s grid (2 channels, 1 KiB
  slices, fewer channels than items), the collectives recorded from one
  sync on a one-peer gloo ring equal, by kind and result bytes, the
  reference's ``stablehlo_collective_stats`` of the same sync on a
  ``(1,)`` mesh, and both count ``n_items`` per-slice and ``n_channels``
  coalesced; the recorder's readers on a hand-made log (kinds, bytes,
  ranks, the cross-pod split, the emission position, the pre-fusion
  bytes); ``first_collective_position`` is None for ``gspmd``'s local
  decode and a tuple inside the op stream for ``hadronio``'s, as in
  ``tests/test_hlo_analysis.py``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, CommConfig, cell_skip_reason,
                                      cells_for)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.core import aggregation as agg
from repro_torch.core import tac
from repro_torch.core.backends import hadronio_overlap as ov
from repro_torch.core.backends import hadronio_overlap_rs as ovrs
from repro_torch.core.channels import Ring
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.models import api
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import dispatch

try:
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import compat as jcompat
    from repro.configs.base import CommConfig as JCommConfig
    from repro.configs.registry import get_config as jax_config
    from repro.configs.registry import get_shape as jax_shape
    from repro.configs.base import cell_skip_reason as jskip
    from repro.configs.base import cells_for as jcells
    from repro.core import tac as jtac
    from repro.launch import hlo_analysis as jhlo
    from repro.launch.mesh import make_mesh
    from repro.models import api as japi
except ImportError:
    jax = None

ARCHES = [a for base in ARCH_IDS for a in (base, base + "-reduced")]
FAMILY = ("hadronio", "hadronio_rs", "hadronio_overlap",
          "hadronio_overlap_rs")


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
    r = Ring(channels=2)
    yield r
    r.close()
    if own:
        dist.destroy_process_group()


# -- arithmetic ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHES)
def test_model_flops_hbm_bytes_and_cells_match_reference(jx, arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert [s.name for s in cells_for(cfg)] == \
        [s.name for s in jcells(jcfg)]
    for name in SHAPES:
        shape, jshape = get_shape(name), jax_shape(name)
        assert (shape.kind, shape.seq_len, shape.global_batch) == \
            (jshape.kind, jshape.seq_len, jshape.global_batch)
        assert cell_skip_reason(cfg, shape) == jskip(jcfg, jshape)
        np.testing.assert_allclose(hlo.model_flops(cfg, shape),
                                   jhlo.model_flops(jcfg, jshape),
                                   rtol=1e-12)
        np.testing.assert_allclose(hlo.model_flops(cfg, shape, 1234),
                                   jhlo.model_flops(jcfg, jshape, 1234),
                                   rtol=1e-12)
        for n, kw in ((256, {}), (512, {}), (4, dict(tp=2, dp=2))):
            np.testing.assert_allclose(
                hlo.analytic_hbm_bytes(cfg, shape, n, **kw),
                jhlo.analytic_hbm_bytes(jcfg, jshape, n, **kw), rtol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(flops=1e17, hbm_bytes=1e9, collective_bytes=1e9, n_chips=256),
    dict(flops=3e15, hbm_bytes=7e12, collective_bytes=2e9, n_chips=512,
         hbm_is_global=False),
    dict(flops=1e9, hbm_bytes=1e14, collective_bytes=1e9, n_chips=1,
         flops_are_global=False),
])
def test_roofline_terms_scale_with_the_peaks(jx, kw):
    got, want = hlo.roofline_terms(**kw), jhlo.roofline_terms(**kw)
    for term, peak in (("compute_s", "PEAK_FLOPS"), ("memory_s", "HBM_BW"),
                       ("collective_s", "ICI_BW")):
        np.testing.assert_allclose(got[term] * getattr(hlo, peak),
                                   want[term] * getattr(jhlo, peak),
                                   rtol=1e-12)


def test_roofline_bottleneck_cases():
    """``tests/test_hlo_analysis.py``'s three cases at the card's
    figures."""
    t = hlo.roofline_terms(flops=1e17, hbm_bytes=1e9, collective_bytes=1e9,
                           n_chips=256)
    assert t["bottleneck"] == "compute"
    t = hlo.roofline_terms(flops=1e9, hbm_bytes=1e14, collective_bytes=1e9,
                           n_chips=1, flops_are_global=False)
    assert t["bottleneck"] == "memory"
    t = hlo.roofline_terms(flops=1e9, hbm_bytes=1e9, collective_bytes=1e13,
                           n_chips=1, flops_are_global=False)
    assert t["bottleneck"] == "collective"
    assert (hlo.PEAK_FLOPS, hlo.HBM_BW, hlo.ICI_BW) == (989e12, 3.35e12,
                                                        450e9)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_input_specs_match_reference(jx, arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in SHAPES:
        got = api.input_specs(cfg, get_shape(name))
        want = japi.input_specs(jcfg, jax_shape(name))
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape)
            assert v.dtype == (torch.int64 if want[k].dtype.kind == "i"
                               else torch.bfloat16)


# -- the recorder -------------------------------------------------------------


def test_readers_on_a_hand_made_log():
    log = hlo.OpLog([
        hlo.Op("aten.mm.default", None, 96),
        hlo.Op("c10d._reduce_scatter_base_.default", "reduce-scatter", 64,
               (0, 1)),
        hlo.Op("c10d.allreduce_.default", "all-reduce", 16, (0, 2)),
        hlo.Op("c10d._allgather_base_.default", "all-gather", 128,
               (0, 1)),
        hlo.Op("c10d.alltoall_base_.default", "all-to-all", 32,
               (0, 1, 2, 3)),
        hlo.Op("aten.add.Tensor", None, 24),
    ])
    st = hlo.collective_stats(log)
    assert st.counts == {"reduce-scatter": 1, "all-reduce": 1,
                         "all-gather": 1, "all-to-all": 1}
    assert st.bytes_ == {"reduce-scatter": 64, "all-reduce": 16,
                         "all-gather": 128, "all-to-all": 32}
    assert st.as_dict()["total_bytes"] == 240 and st.total_ops == 4
    cp = hlo.cross_pod_collective_count(log, 2)
    assert cp == {"in_pod": {"reduce-scatter": 1, "all-gather": 1},
                  "cross_pod": {"all-reduce": 1}, "in_pod_total": 2,
                  "cross_pod_total": 1}
    assert hlo.cross_pod_collective_count(log, 4)["cross_pod_total"] == 0
    assert hlo.first_collective_position(log) == (1, 6)
    assert hlo.first_collective_position(hlo.OpLog()) is None
    with pytest.raises(ValueError):
        hlo.cross_pod_collective_count(log, 0)


def test_recorder_reads_issued_ops_and_result_bytes(ring):
    """Result bytes of each c10d kind (a reduce-scatter into a view of a
    bigger buffer counts the view), global ranks, issue order, the
    counted FLOPs and the memory probe on CPU tensors."""
    x = torch.arange(8, dtype=torch.float32)
    big = torch.empty(16)
    with hlo.record() as log:
        y = x * 2
        dist.all_reduce(y)
        dist.reduce_scatter_tensor(big[4:12], y)
        g = torch.empty(8, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(g, y.to(torch.bfloat16),
                                    group=ring.channel_groups[1])
    kinds = [(op.kind, op.nbytes, op.ranks) for op in log.collectives]
    assert kinds == [("all-reduce", 32, (0,)), ("reduce-scatter", 32, (0,)),
                     ("all-gather", 16, (0,))]
    assert log[0].name == "aten.mul.Tensor" and log[0].nbytes == 64
    assert hlo.first_collective_position(log) == (1, len(log))
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    cost = hlo.flops_and_bytes(torch.mm, a, b)
    assert cost["flops"] == 2 * 4 * 8 * 3
    assert cost["bytes_accessed"] == (32 + 24 + 12) * 4
    mem = hlo.memory_stats(lambda t: t.add_(1) * 3, torch.zeros(256))
    assert mem["argument_size_in_bytes"] == 1024
    assert mem["output_size_in_bytes"] == 1024
    assert mem["alias_size_in_bytes"] == 0
    assert mem["peak_size_in_bytes"] >= 2048


def _grad_tree(seed=7):
    """``test_backend_conformance``'s tree shapes: a 3000-element leaf
    bigger than a 4 KiB bucket, odd dims."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(33, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(129,)).astype(np.float32),
                  "d": rng.normal(size=(2, 3, 5)).astype(np.float32)},
            "e": rng.normal(size=(3000,)).astype(np.float32)}


def _jax_stats(mode, aggregate, grads):
    comm = JCommConfig(mode=mode, channels=2, slice_bytes=1024,
                       ring_capacity_bytes=1 << 20, aggregate=aggregate,
                       hierarchical=False)

    def body(g):
        r = jtac.sync_grads(g, comm, data_axis=("data",))
        outs = tuple(jax.tree.leaves(r.grads)) if r.grads is not None \
            else (r.flat_shard,)
        return outs

    mesh = make_mesh((1,), ("data",))
    f = jax.jit(jcompat.shard_map(body, mesh=mesh, in_specs=(P(),),
                                  out_specs=P()))
    return jhlo.stablehlo_collective_stats(f.lower(grads).as_text())


@pytest.mark.parametrize("aggregate", ["slice", "channel"])
@pytest.mark.parametrize("mode", FAMILY)
def test_recorded_collectives_match_reference_stablehlo(jx, ring, mode,
                                                        aggregate):
    grads = _grad_tree()
    comm = CommConfig(mode=mode, channels=2, slice_bytes=1024,
                      ring_capacity_bytes=1 << 20, aggregate=aggregate,
                      hierarchical=False)
    tgrads = from_numpy_params(grads, "cpu")
    with hlo.record() as log:
        tac.sync_grads(tgrads, comm, ring=ring)
    got = hlo.collective_stats(log)
    want = _jax_stats(mode, aggregate, grads)
    assert got.counts == want.counts
    assert got.bytes_ == want.bytes_
    if mode == "hadronio_overlap":
        n_items = ov.make_bucket_plan(tgrads, comm).n_buckets
    elif mode == "hadronio_overlap_rs":
        n_items = ovrs.rs_bucket_plan(tgrads, comm, 1).n_buckets
    else:
        n_items = agg.make_plan(tgrads, comm).n_slices
    assert n_items > comm.channels
    assert got.total_ops == (n_items if aggregate == "slice"
                             else comm.channels)


def test_first_collective_position_local_vs_wired_decode(jx, ring):
    """The 1-peer local serve decode (``gspmd``, no ring) issues no
    collective and yields None; the ``hadronio`` decode over a one-peer
    ring yields a real position (``tests/test_hlo_analysis.py``)."""
    cfg = get_config("qwen2-0.5b-reduced")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = api.init_cache(cfg, 2, 32, device="cpu")
    dec = {"token": torch.tensor([3, 5]), "pos": torch.tensor([4, 6])}
    positions = {}
    for mode, r in (("gspmd", None), ("hadronio", ring)):
        comm = CommConfig(mode=mode, slice_bytes=512, channels=2,
                          hierarchical=False)
        step = dispatch.make_serve_step(cfg, comm, ring=r)
        with hlo.record() as log:
            step.decode(params, cache, dec)
        positions[mode] = hlo.first_collective_position(log)
    assert positions["gspmd"] is None
    first, total = positions["hadronio"]
    assert 0 < first < total
