"""The reference's public names, imported from repro_torch as from repro,
and held against the reference where they compute:

* EXPORTS — ``repro_torch.core``, ``.optim``, ``.configs``, ``.models``
  and ``.data`` export every name of their reference package's
  ``__all__``; ``core.tac``, ``launch.train``, ``optim.adamw`` and
  ``core.compress`` carry the reference's ``shard_slice_len``,
  ``gather_updated``, ``WatchdogTimeout``, ``clip_by_global_norm`` and
  ``bf16_compress``.
* VALUES — ``make_batches``' first batches bit for bit, ``all_cells``'
  (arch, shape, skip reason) triples and ``describe``'s lines,
  ``shard_slice_len`` over plans of a few sizes, ``clip_by_global_norm``'s
  gradients and norm (below and above the bound, f32 reductions), and
  ``bf16_compress``' wire and residual bit for bit, with and without an
  error-feedback input, on seeded numpy inputs.
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = None

pytestmark = pytest.mark.skipif(jax is None,
                                reason="the JAX reference is not installed")

PACKAGES = ("core", "optim", "configs", "models", "data")
NAMES = {"core.tac": ("shard_slice_len", "gather_updated", "sync_grads",
                      "SyncResult"),
         "launch.train": ("WatchdogTimeout",),
         "optim.adamw": ("clip_by_global_norm", "global_norm", "AdamState"),
         "core.compress": ("bf16_compress",),
         "data.pipeline": ("make_batches",)}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_packages_export_the_references_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(ref.__all__) <= set(port.__all__)
    ns = {}
    exec(f"from repro_torch.{pkg} import *", ns)
    assert set(ref.__all__) <= ns.keys()


@pytest.mark.parametrize("mod", sorted(NAMES))
def test_modules_carry_the_references_names(mod):
    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")
    for name in NAMES[mod]:
        assert hasattr(ref, name) and hasattr(port, name), name
    if mod == "launch.train":
        assert issubclass(port.WatchdogTimeout, RuntimeError)


def test_make_batches_first_batches_equal_the_reference():
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.registry import get_config as jget
    from repro.data import DataConfig as JData
    from repro.data import make_batches as jbatches
    from repro.data import make_source as jsource
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import DataConfig, make_batches, make_source
    for start, hosts in ((0, 1), (5, 2)):
        dc = DataConfig(seq_len=32, global_batch=4, host_index=hosts - 1,
                        num_hosts=hosts)
        jdc = JData(seq_len=32, global_batch=4, host_index=hosts - 1,
                    num_hosts=hosts)
        got = make_batches(make_source(RunConfig(
            model=get_config("qwen2-0.5b-reduced"),
            shape=ShapeConfig("t", "train", 32, 4))), dc, start)
        want = jbatches(jsource(JRun(
            model=jget("qwen2-0.5b-reduced"),
            shape=JShape("t", "train", 32, 4))), jdc, start)
        for g, w in itertools.islice(zip(got, want), 3):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_cell_listing_and_description_equal_the_reference():
    from repro.configs import all_cells as jcells
    from repro.configs import describe as jdescribe
    from repro_torch.configs import all_cells, describe
    got = [(c.name, s.name, r) for c, s, r in all_cells()]
    want = [(c.name, s.name, r) for c, s, r in jcells()]
    assert got == want
    seen = {}
    for (c, _, _), (jc, _, _) in zip(all_cells(), jcells()):
        seen[c.name] = (describe(c), jdescribe(jc))
    for name, (g, w) in seen.items():
        assert g == w, name


@pytest.mark.parametrize("slice_bytes,n_data", [(4096, 1), (4096, 4),
                                                (64 * 1024, 2),
                                                (1 << 20, 8)])
def test_shard_slice_len_equals_the_reference(slice_bytes, n_data):
    from repro.configs.base import CommConfig as JComm
    from repro.core import aggregation as jagg
    from repro.core import tac as jtac
    from repro_torch.configs import CommConfig
    from repro_torch.core import aggregation, tac
    rng = np.random.default_rng(slice_bytes)
    tree = {"a": rng.normal(size=(37, 129)).astype(np.float32),
            "b": rng.normal(size=(1000,)).astype(np.float32)}
    plan = aggregation.make_plan({k: torch.from_numpy(v)
                                  for k, v in tree.items()},
                                 CommConfig(slice_bytes=slice_bytes))
    jplan = jagg.make_plan({k: jnp.asarray(v) for k, v in tree.items()},
                           JComm(slice_bytes=slice_bytes))
    assert tac.shard_slice_len(plan, n_data) == \
        jtac.shard_slice_len(jplan, n_data)


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_by_global_norm_equals_the_reference(max_norm):
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    rng = np.random.default_rng(11)
    tree = {"w": rng.normal(size=(64, 48)).astype(np.float32),
            "b": rng.normal(size=(48,)).astype(np.float32),
            "h": (rng.normal(size=(8, 8)) * 3).astype(np.float32)}
    got, gnorm = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    want, wnorm = jadamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
    for k in tree:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("with_ef", [False, True])
def test_bf16_compress_equals_the_reference_bitwise(with_ef):
    from repro.core import compress as jcompress
    from repro_torch.core import compress
    rng = np.random.default_rng(5)
    slices = (rng.normal(size=(4, 1024)) * 10).astype(np.float32)
    ef = (rng.normal(size=(4, 1024)) * 1e-3).astype(np.float32) \
        if with_ef else None
    wire, res = compress.bf16_compress(
        torch.from_numpy(slices),
        None if ef is None else torch.from_numpy(ef))
    jwire, jres = jcompress.bf16_compress(
        jnp.asarray(slices), None if ef is None else jnp.asarray(ef))
    assert wire.dtype == torch.bfloat16 and res.dtype == torch.float32
    np.testing.assert_array_equal(
        wire.view(torch.int16).numpy(),
        np.asarray(jwire).view(np.int16))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
