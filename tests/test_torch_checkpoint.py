"""repro_torch's checkpoint store against the JAX reference's, on the
CPU.

* ``tests/test_checkpoint.py`` case for case against the port's store:
  round trip, GC, async save, atomic overwrite, dtype cast on restore,
  the mismatch hook; the ``reshard_tac_opt`` invariant; the
  ``hadronio_rs`` and ``hadronio_overlap_rs`` reshard cases and
  ``make_on_mismatch`` against ``repro.launch.elastic``'s on the same
  numpy inputs, bitwise.
* Interchange on ``qwen2-0.5b-reduced`` (f32), from a 2-step JAX TAC run
  of ``hadronio/bf16`` and of ``hadronio_rs/bf16``: a checkpoint written
  by ``repro``'s store restores into the port bitwise (every leaf
  against ``convert.from_numpy_train_state``), one written by the port
  restores through ``repro``'s store bitwise, and the two directories
  hold the same files, byte for byte.
* bf16: the port writes the reference's bytes for a bf16 leaf and reads
  the reference's ``|V2`` file back to the same bits (the reference's
  own restore cannot: ``astype(bfloat16)`` of ``|V2`` raises).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore, leaf_files
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.backends import get_backend
from repro_torch.launch import elastic, steps
from repro_torch.models.convert import from_numpy_train_state

try:
    import jax
    import jax.numpy as jnp
    from repro import compat as jcompat
    from repro.checkpoint import CheckpointStore as JStore
    from repro.configs.base import CommConfig as JCommConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.core.backends import get_backend as jax_backend
    from repro.data import pipeline as jdata
    from repro.launch import elastic as jelastic
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh
except ImportError:
    jax = None

ARCH = "qwen2-0.5b-reduced"
B, S = 2, 24


@pytest.fixture(scope="module")
def jx():
    if jax is None:
        pytest.skip("the JAX reference is not installed")


def tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"mu": torch.ones(5), "count": 7}}


def like_of(t):
    return {"w": torch.empty(3, 4, device="meta"),
            "opt": {"mu": torch.empty(5, device="meta"), "count": 0}}


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def assert_same(got, want):
    """Leaf for leaf: the same names, ints equal, tensors the same dtype,
    shape and bits."""
    g, w = leaf_files(got), leaf_files(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        if not torch.is_tensor(b):
            assert a == b and type(a) is type(b), name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(bits(a), bits(b)), name


# -- tests/test_checkpoint.py, case for case ---------------------------------


def test_roundtrip(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.save(3, tree(), extra={"loss": 1.0})
    assert st.latest_step() == 3
    assert_same(st.restore(3, like_of(tree()), device="cpu"), tree())
    assert st.manifest(3)["extra"]["loss"] == 1.0


def test_gc_keeps_last_k(tmp_path):
    st = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        st.save(s, tree())
    assert st.available_steps() == [3, 4]
    assert st.latest_step() == 4


def test_async_save(tmp_path):
    """The snapshot is taken before ``save_async`` returns: changing the
    state in place afterwards does not reach the files."""
    st = CheckpointStore(str(tmp_path))
    t = tree()
    st.save_async(5, t)
    t["w"].mul_(-1)
    st.wait()
    assert st.latest_step() == 5
    assert_same(st.restore(5, like_of(tree()), device="cpu"), tree())


def test_async_write_error_raises_in_wait(tmp_path, monkeypatch):
    st = CheckpointStore(str(tmp_path))
    monkeypatch.setattr(np, "save", lambda *a, **k: (_ for _ in ()).throw(
        OSError("disk full")))
    st.save_async(1, tree())
    with pytest.raises(OSError, match="disk full"):
        st.wait()
    assert st.latest_step() is None
    st.wait()                                 # raised once


def test_atomic_overwrite(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.save(1, tree())
    t2 = tree()
    t2["w"] = t2["w"] * 2
    st.save(1, t2)
    r = st.restore(1, like_of(tree()), device="cpu")
    assert torch.equal(r["w"], tree()["w"] * 2)
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000001"]


def test_dtype_cast_on_restore(tmp_path):
    st = CheckpointStore(str(tmp_path))
    w = torch.tensor([1.0, 1 + 2 ** -9, -3.3, 1e-3])
    st.save(1, {"w": w})
    r = st.restore(1, {"w": torch.empty(4, dtype=torch.bfloat16,
                                        device="meta")}, device="cpu")
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(bits(r["w"]), bits(w.to(torch.bfloat16)))


def test_mismatch_hook(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.save(1, {"m": torch.arange(8.0).reshape(2, 4)})
    like = {"m": torch.empty(4, 2, device="meta")}
    with pytest.raises(ValueError):
        st.restore(1, like, device="cpu")
    r = st.restore(1, like, device="cpu",
                   on_mismatch=lambda n, a, ref: a.reshape(4, 2))
    assert r["m"].shape == (4, 2)


def test_reshard_tac_opt_roundtrip(jx):
    """Re-slicing flat moment shards keeps the global vector for any old
    and new ring sizes, and equals the reference's re-slice."""
    n_slices, slice_elems = 3, 512 * 4
    glob2 = np.arange(n_slices * slice_elems, dtype=np.float32).reshape(
        n_slices, slice_elems)

    def shards_for(n):
        c = slice_elems // n
        return np.stack([
            np.concatenate([glob2[s, i * c:(i + 1) * c]
                            for s in range(n_slices)])
            for i in range(n)])

    for old, new in [(8, 4), (4, 8), (8, 8), (2, 16)]:
        mu_old = shards_for(old)
        nu_old = mu_old * 2
        mu_new, nu_new = elastic.reshard_tac_opt(mu_old, nu_old, old, new,
                                                 n_slices)
        np.testing.assert_array_equal(mu_new, shards_for(new))
        for a, b in zip((mu_new, nu_new), jelastic.reshard_tac_opt(
                mu_old, nu_old, old, new, n_slices)):
            np.testing.assert_array_equal(a, b)


def _zero1_runs(n_shards, mode="hadronio_overlap_rs"):
    kw = dict(mode=mode, slice_bytes=16 * 1024)
    jrun = JRunConfig(model=jax_config(ARCH),
                      shape=JShapeConfig("t", "train", 16, 4),
                      comm=JCommConfig(hierarchical=False, **kw))
    trun = RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", 16, 4),
                     comm=CommConfig(**kw))
    shape = tuple(get_backend(mode).state_specs(trun, n_shards).opt.mu.shape)
    assert (n_shards,) + shape == tuple(
        jax_backend(mode).state_specs(jrun, n_shards).opt.mu.shape)
    return jrun, trun, (n_shards,) + shape


@pytest.mark.parametrize("mode", ["hadronio_rs", "hadronio_overlap_rs"])
def test_reshard_power_of_two_preserves_values(jx, mode):
    """Ring changes that keep the bucket alignment re-slice the old
    moments exactly, as the reference's rule does."""
    jrun, trun, shape_old = _zero1_runs(2, mode)
    stacked = np.arange(np.prod(shape_old), dtype=np.float32).reshape(
        shape_old)
    out = get_backend(mode).reshard_flat_shards(trun, stacked, 4)
    assert tuple(out.shape) == _zero1_runs(4, mode)[2]
    np.testing.assert_array_equal(np.sort(out.reshape(-1)),
                                  np.sort(stacked.reshape(-1)))
    np.testing.assert_array_equal(
        out, jax_backend(mode).reshard_flat_shards(jrun, stacked, 4))


def test_reshard_odd_group_replans_and_reinits(jx):
    jrun, trun, shape_old = _zero1_runs(2)
    stacked = np.ones(shape_old, np.float32)
    out = get_backend("hadronio_overlap_rs").reshard_flat_shards(
        trun, stacked, 3)                   # lcm 512 -> 1536
    assert tuple(out.shape) == _zero1_runs(3)[2]
    assert out.dtype == np.float32 and not out.any()
    np.testing.assert_array_equal(out, jax_backend(
        "hadronio_overlap_rs").reshard_flat_shards(jrun, stacked, 3))


@pytest.mark.parametrize("mode,old,new", [
    ("hadronio_overlap_rs", 2, 3), ("hadronio_overlap_rs", 2, 4),
    ("hadronio_overlap_rs", 4, 2), ("hadronio_rs", 2, 4),
    ("hadronio_rs", 4, 2)])
def test_make_on_mismatch_matches_jax(jx, mode, old, new):
    """The elastic hook on the same numpy inputs as the reference's:
    flat moments through the backend's rule (the replan path included),
    error-feedback residuals reset to zero by name, not by shape; runs
    with no ring-sized state get no hook."""
    jrun, trun, shape_old = _zero1_runs(old, mode)
    _, _, shape_new = _zero1_runs(new, mode)
    rng = np.random.default_rng(old * 10 + new)
    hook, jhook = elastic.make_on_mismatch(trun), \
        jelastic.make_on_mismatch(jrun)
    arr = rng.normal(size=shape_old).astype(np.float32)
    got = hook(".opt_.mu.npy", arr, torch.empty(shape_new, device="meta"))
    np.testing.assert_array_equal(got, jhook(
        ".opt_.mu.npy", arr, jax.ShapeDtypeStruct(shape_new, jnp.float32)))
    ef = rng.normal(size=(old, 512)).astype(np.float32)
    got = hook(".ef_0.npy", ef, torch.empty(new, 1536, device="meta"))
    assert got.shape == (new, 1536) and not got.any()
    np.testing.assert_array_equal(got, jhook(
        ".ef_0.npy", ef, jax.ShapeDtypeStruct((new, 1536), jnp.float32)))
    plain = dataclasses.replace(trun, comm=CommConfig(mode="hadronio"))
    assert elastic.make_on_mismatch(plain) is None


# -- interchange with the reference's store ----------------------------------


def _jax_state(mode):
    """(jax run, port run, the JAX TAC state after 2 steps)."""
    comm = dict(mode=mode, compress="bf16", pack="pallas",
                slice_bytes=64 * 1024, channels=4)
    jrun = JRunConfig(model=jax_config(ARCH),
                      shape=JShapeConfig("t", "train", S, B),
                      comm=JCommConfig(hierarchical=False, **comm),
                      warmup_steps=1, total_steps=2)
    trun = RunConfig(model=get_config(ARCH),
                     shape=ShapeConfig("t", "train", S, B),
                     comm=CommConfig(**comm), warmup_steps=1, total_steps=2)
    mesh = make_mesh((1,), ("data",))
    with jcompat.set_mesh(mesh):
        step_fn, _, _ = jsteps.make_train_step(jrun, mesh)
        state = jsteps.init_tac_state(jax.random.PRNGKey(0), jrun, 1)
        f = jax.jit(step_fn)
        for k in range(2):
            b = jdata.batch_at(jdata.SyntheticSource(
                jrun.model.vocab_size, 0), jdata.DataConfig(S, B), k)
            state, _ = f(state, {n: jnp.asarray(v) for n, v in b.items()})
    return jrun, trun, state


@pytest.mark.parametrize("mode", ["hadronio", "hadronio_rs"])
def test_checkpoints_interchange_with_jax(jx, tmp_path, mode):
    jrun, trun, jstate = _jax_state(mode)
    np_state = jax.tree.map(np.asarray, jstate)
    want = from_numpy_train_state(np_state, "cpu")
    assert int(np_state.opt.count) == 2 and np.abs(np_state.ef).max() > 0

    # repro -> port
    JStore(str(tmp_path / "jax")).save(2, jstate, extra={"loss": 1.5})
    port = CheckpointStore(str(tmp_path / "jax"), rows=steps.ring_rows)
    got = port.restore(port.latest_step(), steps.abstract_state(trun, 1),
                       device="cpu")
    assert_same(got, want)

    # port -> repro
    mine = CheckpointStore(str(tmp_path / "port"), rows=steps.ring_rows)
    mine.save(2, want, extra={"loss": 1.5})
    back = JStore(str(tmp_path / "port")).restore(
        2, jsteps.abstract_tac_state(jrun, 1))
    jl = jax.tree_util.tree_leaves_with_path(jstate)
    bl = jax.tree_util.tree_leaves_with_path(back)
    assert len(jl) == len(bl)
    for (path, a), (_, b) in zip(jl, bl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype.itemsize
                                      == 4 else a, b.view(np.int32)
                                      if b.dtype.itemsize == 4 else b)

    # the same files, byte for byte, and the same manifest leaves
    d1, d2 = tmp_path / "jax" / "step_00000002", \
        tmp_path / "port" / "step_00000002"
    files = sorted(os.listdir(d1))
    assert files == sorted(os.listdir(d2))
    assert (".opt_.mu.npy" in files) == (mode == "hadronio_rs")
    for name in files:
        if name != "manifest.json":
            assert (d1 / name).read_bytes() == (d2 / name).read_bytes(), \
                name
    m1, m2 = JStore(str(tmp_path / "jax")).manifest(2), mine.manifest(2)
    assert m1["leaves"] == m2["leaves"] and m1["extra"] == m2["extra"]


def test_bf16_leaves_are_the_references_bytes(jx, tmp_path):
    rng = np.random.default_rng(0)
    w32 = rng.normal(size=(2, 3)).astype(np.float32)
    m = rng.normal(size=(2,)).astype(np.float32)
    jtree = {"w": jnp.asarray(w32, jnp.bfloat16), "m": jnp.asarray(m)}
    ttree = {"w": torch.from_numpy(w32).to(torch.bfloat16),
             "m": torch.from_numpy(m)}
    wbits = np.asarray(jtree["w"]).view(np.int16)
    assert np.array_equal(bits(ttree["w"]).numpy(), wbits)
    JStore(str(tmp_path / "jax")).save(1, jtree)
    CheckpointStore(str(tmp_path / "port")).save(1, ttree)
    for name in ("w.npy", "m.npy"):
        a = tmp_path / "jax" / "step_00000001" / name
        b = tmp_path / "port" / "step_00000001" / name
        assert a.read_bytes() == b.read_bytes(), name
    ref = np.load(tmp_path / "jax" / "step_00000001" / "w.npy")
    assert ref.dtype.kind == "V"            # what the reference reads back
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "step_00000001" / "w.npy").view(np.int16),
        ref.view(np.int16))
    assert JStore(str(tmp_path / "jax")).manifest(1)["leaves"] == \
        CheckpointStore(str(tmp_path / "port")).manifest(1)["leaves"]
    like = {"w": torch.empty(2, 3, dtype=torch.bfloat16, device="meta"),
            "m": torch.empty(2, device="meta")}
    got = CheckpointStore(str(tmp_path / "jax")).restore(1, like,
                                                         device="cpu")
    assert_same(got, ttree)


def test_restore_raises_without_cuda(tmp_path, monkeypatch):
    st = CheckpointStore(str(tmp_path))
    st.save(1, tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.restore(1, like_of(tree()))
