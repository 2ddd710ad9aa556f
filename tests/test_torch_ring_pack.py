"""repro_torch ring pack/unpack: the port's ``kernels.ops.pack_slices`` /
``unpack_slices`` and their plain versions in ``kernels.ref`` held bit
for bit against the JAX reference's ``repro.kernels.ops`` (the Pallas
kernels in interpret mode, as tests/test_kernels.py runs them) and
``repro.kernels.ref`` on the same numpy inputs; the error-feedback
telescoping property; and, with the ``cuda`` marker (skipped with a
reason where there is no card), the CUDA kernels against the plain
versions on the card.

Exactness is bitwise throughout, as the reference's own tests demand
(tests/test_kernels.py: ``rel_close(..., 0, 0)``): every stage is an
elementwise add, a round-to-nearest-even cast or an exact subtraction.

On the card machine (no JAX there) run the kernel tests alone:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_ring_pack.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

try:                          # the card's machine has no JAX installed
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None

# the reference's shapes (tests/test_kernels.py), plus a ragged length
SHAPES = [(1, 512), (3, 1024), (5, 8192), (3, 4608), (5, 1536), (7, 2560),
          (1, 5632), (3, 1000)]
WIRES = ["bfloat16", "float32"]
EFS = ["ef", "no_ef", "ef_none"]     # with EF, without EF, EF on but None


@pytest.fixture
def jax_ref():
    if jops is None:
        pytest.skip("the JAX reference is not installed here")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(n * s,)).astype(np.float32)
    flat[::97] = -0.0                 # signed zeros cross the EF add
    ef = (rng.normal(size=(n, s)) * 0.01).astype(np.float32)
    return flat, ef


def _bits(x) -> np.ndarray:
    """The raw bit pattern of a torch or JAX array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _call(mod, flat, ef, n, s, wire, mode, to):
    """``mod.pack_slices`` (port or JAX) in one of the three EF modes."""
    return mod.pack_slices(to(flat), None if mode == "ef_none" else to(ef),
                           n_slices=n, slice_elems=s, wire_dtype=wire,
                           with_ef=mode != "no_ef")


@pytest.mark.parametrize("n,s", SHAPES)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mode", EFS)
def test_pack_unpack_bitwise_vs_jax(n, s, wire, mode, jax_ref):
    flat, ef = _inputs(n, s, n * s)
    tw, te = _call(ops, flat, ef, n, s, wire, mode, torch.from_numpy)
    rw, re = _call(ref, flat, ef, n, s, wire, mode, torch.from_numpy)
    jw, je = _call(jref, flat, ef, n, s, wire, mode, jnp.asarray)
    assert tw.shape == (n, s) and tw.dtype == getattr(torch, wire)
    np.testing.assert_array_equal(_bits(tw), _bits(jw))
    np.testing.assert_array_equal(_bits(rw), _bits(jw))
    if mode == "no_ef":
        assert te is None and je is None
    else:
        np.testing.assert_array_equal(_bits(te), _bits(je))
        np.testing.assert_array_equal(_bits(re), _bits(je))
    if s % 512 == 0:                 # the Pallas kernel tiles 512-aligned
        # "EF on, ef=None" is a zero residual, which the port adds (so
        # -0.0 becomes +0.0, as in the JAX plain version). The JAX kernel
        # wrapper makes its zeros inside jit, where XLA folds x + 0 to x
        # and keeps -0.0, so it gets the zeros as an argument here.
        zeros = np.zeros_like(ef)
        kw, ke = _call(jops, flat, zeros if mode == "ef_none" else ef, n,
                       s, wire, "ef" if mode == "ef_none" else mode,
                       jnp.asarray)
        np.testing.assert_array_equal(_bits(tw), _bits(kw))
        if mode != "no_ef":
            np.testing.assert_array_equal(_bits(te), _bits(ke))
        np.testing.assert_array_equal(_bits(ops.unpack_slices(tw)),
                                      _bits(jops.unpack_slices(kw)))
    np.testing.assert_array_equal(_bits(ops.unpack_slices(tw)),
                                  _bits(jref.unpack_slices(jw)))


def test_ef_telescopes():
    """Error feedback (tests/test_kernels.py:63): the sum of the wire
    values plus the final residual equals the sum of the inputs."""
    rng = np.random.default_rng(1)
    n, s = 2, 512
    ef = None
    total_wire = torch.zeros((n, s))
    total_in = torch.zeros((n, s))
    for _ in range(4):
        flat = torch.from_numpy(rng.normal(size=(n * s,)).astype(np.float32))
        total_in += flat.view(n, s)
        wire, ef = ops.pack_slices(flat, ef, n_slices=n, slice_elems=s)
        total_wire += wire.float()
    torch.testing.assert_close(total_wire + ef, total_in, atol=1e-5, rtol=0)
    assert float(ef.abs().max()) > 0          # the wire really was lossy


def test_cpu_path_launches_no_kernel():
    """A CPU tensor goes to the plain version: nothing is built and the
    launch counters do not move."""
    flat, ef = (torch.from_numpy(x) for x in _inputs(2, 512, 2))
    before = (ops.pack_slices.launches, ops.unpack_slices.launches)
    wire, _ = ops.pack_slices(flat, ef, n_slices=2, slice_elems=512)
    ops.unpack_slices(wire)
    assert (ops.pack_slices.launches, ops.unpack_slices.launches) == before
    assert "ring_pack" not in build.BUILD_INFO


def test_ops_reject_bad_inputs():
    flat, ef = (torch.from_numpy(x) for x in _inputs(2, 512, 3))
    kw = dict(n_slices=2, slice_elems=512)
    with pytest.raises(ValueError, match="flat"):
        ops.pack_slices(flat[:1000], ef, **kw)
    with pytest.raises(ValueError, match="flat"):
        ops.pack_slices(flat.double(), ef, **kw)
    with pytest.raises(ValueError, match="ef"):
        ops.pack_slices(flat, ef.T.contiguous(), **kw)
    with pytest.raises(ValueError, match="ef"):
        ops.pack_slices(flat, ef.to(torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="wire_dtype"):
        ops.pack_slices(flat, ef, wire_dtype="float16", **kw)
    with pytest.raises(ValueError, match="n_slices"):
        ops.pack_slices(flat, ef, n_slices=0, slice_elems=512)
    with pytest.raises(ValueError, match="wire"):
        ops.unpack_slices(flat)
    with pytest.raises(ValueError, match="out_dtype"):
        ops.unpack_slices(flat.view(2, 512), out_dtype="bfloat16")
    with pytest.raises(ValueError, match="devices"):
        ops.pack_slices(flat, ef.to("meta"), **kw)


# -- the CUDA kernels on the card --------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", SHAPES)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mode", EFS)
def test_kernels_match_plain_on_card(n, s, wire, mode, cuda):
    flat, ef = _inputs(n, s, 5)
    to = lambda a: torch.from_numpy(a).to(cuda)
    before = (ops.pack_slices.launches, ops.unpack_slices.launches)
    kw, ke = _call(ops, flat, ef, n, s, wire, mode, to)
    out = ops.unpack_slices(kw)
    torch.cuda.synchronize()
    assert (ops.pack_slices.launches, ops.unpack_slices.launches) == \
        (before[0] + 1, before[1] + 1)
    rw, re = _call(ref, flat, ef, n, s, wire, mode, to)
    assert torch.equal(_bits_t(kw), _bits_t(rw))
    assert (ke is None) == (re is None)
    if ke is not None:
        assert torch.equal(_bits_t(ke), _bits_t(re))
    assert torch.equal(_bits_t(out), _bits_t(ref.unpack_slices(rw)))


@pytest.mark.cuda
def test_kernel_misaligned_views_on_card(cuda):
    """Views that start off a 16-byte boundary take the scalar loop and
    still match the plain version bit for bit."""
    flat, ef = _inputs(3, 1000, 6)
    f = torch.from_numpy(np.concatenate([[0.0], flat]).astype(np.float32))
    f = f.to(cuda)[1:]
    assert f.data_ptr() % 16 != 0
    e = torch.from_numpy(ef).to(cuda)
    kw, ke = ops.pack_slices(f, e, n_slices=3, slice_elems=1000)
    rw, re = ref.pack_slices(f, e, n_slices=3, slice_elems=1000)
    assert torch.equal(_bits_t(kw), _bits_t(rw))
    assert torch.equal(_bits_t(ke), _bits_t(re))


def _bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
