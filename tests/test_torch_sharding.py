"""repro_torch's sharding rules against the reference's, on the
reference's production meshes without devices: ``POD`` (16, 16)
``("data", "model")`` and ``MULTI`` (2, 16, 16) ``("pod", "data",
"model")`` (``launch/mesh.make_abstract_mesh`` beside the reference's
``AbstractMesh``).

* ``tests/test_sharding.py`` case for case: the TP rules, the
  divisibility fallback, the experts rule, no axis reused within a
  param, the FSDP toggle, every param sharded somewhere on a pod
  (110b, mixtral, rwkv6, recurrentgemma), 110b's decode_32k cache over
  both axes, the batch rules.
* ``spec_partition`` equals the reference's ``PartitionSpec`` (as a
  tuple) for every param of every registry id, with FSDP on and off, on
  both meshes.
* ``cache_shardings`` over ``api.cache_specs`` equals the reference's
  for every id at the decode shapes (decode_32k, and long_500k's batch
  of one, which shards the cache length), and ``batch_sharding`` over
  ``api.input_specs`` for every id and shape, on both meshes.
* The shape functions: ``api.abstract``, ``api.cache_specs``,
  ``attention.kv_cache_specs``, ``rwkv6.init_state_specs`` and
  ``hybrid.hybrid_cache_specs`` give the reference's shapes and dtypes
  for every id.
* ``make_shard_fn``'s constraint for each logical tuple of the threaded
  sites (``act_partition``) equals the spec the reference's
  ``shard_fn`` hands ``with_sharding_constraint`` (or its leaving the
  value unconstrained), under the ``REPRO_SP_EXPLICIT`` and
  ``REPRO_NO_SP`` switches too; ``placements`` turns each into DTensor
  placements; and on a one-peer ``DeviceMesh`` the shard function
  redistributes a DTensor and passes a plain tensor through.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_shape as jax_shape
from repro.launch import sharding as jsharding
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models import api as japi
from repro.models import attention as jatt
from repro.models import hybrid as jhyb
from repro.models import rwkv6 as jrwkv
from repro.models.common import tree_paths as jtree_paths
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_abstract_mesh, make_device_mesh
from repro_torch.launch.sharding import (act_partition, batch_sharding,
                                         cache_shardings, make_shard_fn,
                                         placements, spec_partition)
from repro_torch.models import api
from repro_torch.models import attention as att
from repro_torch.models import hybrid as hyb
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.common import ParamSpec, tree_paths

POD = make_abstract_mesh((16, 16), ("data", "model"))
MULTI = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
JPOD = jax_abstract_mesh((16, 16), ("data", "model"))
JMULTI = jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
MESHES = {"pod": (POD, JPOD), "multi": (MULTI, JMULTI)}


def _flat_axes(part) -> list:
    out = []
    for a in part:
        if a is not None:
            out.extend(a if isinstance(a, tuple) else (a,))
    return out


# -- tests/test_sharding.py, case for case -----------------------------------


def test_tp_rules():
    s = ParamSpec((4096, 14336), ("embed", "mlp"))
    assert spec_partition(POD, s) == ("data", "model")
    s = ParamSpec((4096, 32, 128), ("embed", "heads", None))
    assert spec_partition(POD, s) == ("data", "model", None)
    assert placements(POD, ("data", "model", None)) == (Shard(0), Shard(1))


def test_divisibility_fallback():
    # qwen1.5-4b: 20 heads on a 16-way model axis -> replicated heads dim
    s = ParamSpec((2560, 20, 128), ("embed", "heads", None))
    assert spec_partition(POD, s) == ("data", None, None)
    assert placements(POD, ("data", None, None)) == (Shard(0), Replicate())


def test_experts_rule():
    s = ParamSpec((16, 6144, 10752), ("experts", "embed", "mlp"))
    part = spec_partition(POD, s)
    assert part[0] == "model"          # EP over model axis
    assert part[1] == "data"           # expert-internal FSDP
    assert part[2] is None             # model already used by experts
    assert placements(POD, part) == (Shard(1), Shard(0))


def test_no_axis_reuse_within_param():
    for path, spec in tree_paths(api.specs(get_config("qwen1.5-110b"))):
        flat = _flat_axes(spec_partition(POD, spec))
        assert len(flat) == len(set(flat)), path


def test_fsdp_toggle():
    s = ParamSpec((4096, 14336), ("embed", "mlp"))
    assert spec_partition(POD, s, fsdp=False) == (None, "model")


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "mixtral-8x7b",
                                  "rwkv6-7b", "recurrentgemma-9b"])
def test_every_param_gets_some_sharding_on_pod(arch):
    """At 110B scale every big tensor must shard somewhere: the
    replicated residue per peer stays under 4 GB of bf16."""
    per_chip = 0
    for path, spec in tree_paths(api.specs(get_config(arch))):
        div = 1
        for a in _flat_axes(spec_partition(POD, spec)):
            div *= POD.shape[a]
        per_chip += int(np.prod(spec.shape)) * 2 // div
    assert per_chip < 4e9, (arch, per_chip / 1e9)


def test_cache_shardings_decode32k_110b():
    cache = api.cache_specs(get_config("qwen1.5-110b"), 128, 32768)
    spec = cache_shardings(POD, cache)["k"].spec
    # (L, B, S, KV, Dh): batch over data; seq or kv over model
    assert spec[1] == "data"
    assert "model" in _flat_axes(spec), spec
    n = np.prod([80, 128, 32768, 8, 128]) * 2 / (16 * 16)
    assert n < 3e9


def test_batch_sharding_rules():
    toks = torch.empty((256, 4096), dtype=torch.int64, device="meta")
    sh = batch_sharding(MULTI, {"tokens": toks})
    assert sh["tokens"].spec[0] == ("pod", "data")
    assert sh["tokens"].placements == (Shard(0), Shard(0), Replicate())
    small = torch.empty((3, 4), dtype=torch.int64, device="meta")
    sh = batch_sharding(MULTI, {"x": small})
    assert sh["x"].spec == tuple(P())        # indivisible -> replicated
    assert sh["x"].placements == (Replicate(),) * 3


# -- every param, cache leaf and input of every registry id ------------------


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_partition_matches_reference(arch, mesh, fsdp):
    """Every param's partition equals the reference's ``PartitionSpec``
    (as a tuple), and its placements put each named axis's mesh dim on
    that tensor dim."""
    m, jm = MESHES[mesh]
    specs = tree_paths(api.specs(get_config(arch)))
    jspecs = jtree_paths(japi.specs(jax_config(arch)))
    assert [p for p, _ in specs] == [p for p, _ in jspecs]
    for (path, spec), (_, jspec) in zip(specs, jspecs):
        assert (spec.shape, spec.axes) == (jspec.shape, jspec.axes), path
        part = spec_partition(m, spec, fsdp=fsdp)
        want = jsharding.spec_partition(jm, jspec, fsdp=fsdp)
        assert part == tuple(want), (path, part, want)
        pls = placements(m, part)
        for i, axis in enumerate(m.axis_names):
            dims = [d for d, a in enumerate(part)
                    if a is not None and axis in _flat_axes((a,))]
            assert pls[i] == (Shard(dims[0]) if dims else Replicate())


def _decode_cells():
    return [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_cache_shardings_match_reference(arch, shape, mesh):
    m, jm = MESHES[mesh]
    sh = jax_shape(shape)
    cache = api.cache_specs(get_config(arch), sh.global_batch, sh.seq_len)
    jcache = japi.cache_specs(jax_config(arch), sh.global_batch, sh.seq_len)
    got = tree_paths(cache_shardings(m, cache))
    want = jtree_paths(jsharding.cache_shardings(jm, jcache))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.spec == tuple(w.spec), (path, g.spec, w.spec)
        placements(m, g.spec)       # every cache partition has a DTensor form


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_sharding_matches_reference(arch, mesh):
    m, jm = MESHES[mesh]
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        inputs = api.input_specs(get_config(arch), get_shape(name))
        jinputs = japi.input_specs(jax_config(arch), jax_shape(name))
        assert sorted(inputs) == sorted(jinputs)
        got, want = batch_sharding(m, inputs), jsharding.batch_sharding(
            jm, jinputs)
        for k in inputs:
            assert got[k].spec == tuple(want[k].spec), (name, k)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "") if torch.is_tensor(x) \
        else jnp.dtype(x.dtype).name


def _same_layout(tree, jtree):
    got, want = tree_paths(tree), jtree_paths(jtree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", path
        assert (tuple(g.shape), _dtype(g)) == (tuple(w.shape), _dtype(w)), \
            path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_functions_match_reference(arch):
    """``api.abstract`` and ``api.cache_specs`` (at decode_32k and a
    short cache), and the family's own cache shape function, against
    the reference's: paths, shapes and dtypes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    _same_layout(api.abstract(cfg), japi.abstract(jcfg))
    for b, n in ((128, 32768), (2, 40)):
        _same_layout(api.cache_specs(cfg, b, n),
                     japi.cache_specs(jcfg, b, n))
    dt = cfg.compute_dtype
    if cfg.family == "ssm":
        _same_layout(rwkv.init_state_specs(cfg, 3, dt),
                     jrwkv.init_state_specs(jcfg, 3, dt))
    elif cfg.family == "hybrid":
        _same_layout(hyb.hybrid_cache_specs(cfg, 3, dt),
                     jhyb.hybrid_cache_specs(jcfg, 3, dt))
    else:
        args = (cfg.num_layers, 3, 40, cfg.num_kv_heads, cfg.head_dim)
        _same_layout(att.kv_cache_specs(*args, dt),
                     jatt.kv_cache_specs(*args, dt))


# -- make_shard_fn's constraints ---------------------------------------------

# each logical tuple of the threaded sites with an activation shape of a
# dense model on the pod: (B, S, D) = (256, 4096, 2048), 16 heads of 128
B, S, D, H, KV, DH, F, V = 256, 4096, 2048, 16, 4, 128, 5632, 32000
SITES = [
    ((B, S, D), ("batch", "seq", None)),             # embed, residuals
    ((B, S, D), ("batch", "seq_gather", None)),      # normed block input
    ((B, S, H, DH), ("batch", None, "heads", None)),     # q
    ((B, S, KV, DH), ("batch", None, "kv_heads", None)),  # k, v
    ((B, S, D), ("batch", None, "embed")),           # out_project
    ((B, S, F), ("batch", None, "mlp")),             # the MLP's hidden
    ((B, S, V), ("batch", None, "vocab")),           # logits
    ((B, 1, H, DH), ("batch", "rep", "rep", "rep")),      # decode q
    ((B, 32768, KV, DH), ("batch", "seq_model", "rep", "rep")),  # cache
    ((B, KV, 4, 1, 32768), ("batch", "rep", "rep", "rep", "seq_model")),
    ((B, 1, H, DH), ("batch", None, "heads", None)),      # decode out
    ((3, 5, 7), ("batch", "seq", None)),             # nothing divides
]


def _reference_constraint(jm, shape, logical, monkeypatch, manual=(),
                          sp_explicit=None):
    """The spec the reference's shard_fn pins, or None when it returns
    the value unconstrained."""
    seen = []

    def wsc(x, s):
        seen.append(s.spec)
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", wsc)
    fn = jsharding.make_shard_fn(jm, manual_axes=manual,
                                 sp_explicit=sp_explicit)
    fn(jax.ShapeDtypeStruct(shape, jnp.float32), logical)
    return tuple(seen[0]) if seen else None


@pytest.mark.parametrize("env", ["", "sp_explicit", "no_sp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_fn_constraints_match_reference(mesh, env, monkeypatch):
    m, jm = MESHES[mesh]
    monkeypatch.delenv("REPRO_SP_EXPLICIT", raising=False)
    monkeypatch.delenv("REPRO_NO_SP", raising=False)
    if env == "no_sp":
        monkeypatch.setenv("REPRO_NO_SP", "1")
    sp = env == "sp_explicit"
    pinned = 0
    for manual in ((), ("data",)):
        for shape, logical in SITES:
            want = _reference_constraint(jm, shape, logical, monkeypatch,
                                         manual, sp)
            got = act_partition(m, shape, logical, manual_axes=manual,
                                sp_explicit=sp, no_sp=env == "no_sp")
            assert got == want, (shape, logical, manual, got, want)
            if got is not None:
                pinned += 1
                pls = placements(m, got)
                assert len(pls) == len(m.axis_names)
    assert pinned >= 16, pinned


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


def test_shard_fn_on_a_device_mesh(group):
    """On a one-peer (1, 1) DeviceMesh every rule falls back (no axis
    above size 1): a ``"rep"`` pin still redistributes a DTensor (to
    replicated), an unconstrained site returns it as it is, and a plain
    tensor passes every site untouched. Params and the batch distribute
    to their placements with no collective."""
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu")
    fn = make_shard_fn(mesh)
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert fn(x, ("batch", "rep", None)) is x
    d = sharding.distribute(x, sharding.Sharding(mesh, (None,) * 3))
    assert isinstance(d, DTensor) and d.placements == (Replicate(),) * 2
    assert fn(d, ("batch", "seq", None)) is d
    pinned = fn(d, ("batch", "rep", None))
    assert pinned.placements == (Replicate(),) * 2
    assert torch.equal(pinned.full_tensor(), x)
    assert make_shard_fn(None)(x, ("batch", "rep", None)) is x
    ps = sharding.param_shardings(mesh, api.specs(get_config(
        "qwen1.5-4b-reduced")))
    assert all(s.placements == (Replicate(),) * 2
               for _, s in tree_paths(ps))
