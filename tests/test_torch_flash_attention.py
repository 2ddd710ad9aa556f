"""repro_torch flash attention: the port's ``kernels.ops.flash_attention``
held against the JAX reference (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and against the port's plain version, on
the same numpy inputs; plus the CUDA kernels against the plain version
on the card (``cuda`` marker: skipped with a reason where there is none):
bf16 runs the tensor-core kernel, f32 the FMA kernel. K/V go to the port
at their KV heads (GQA/MQA read in place); the JAX reference is fed the
same K/V expanded by its own ``expand_kv``.

Tolerances are the reference's own (tests/test_kernels.py): f32
2e-4/2e-3 (sums in another order), bf16 3e-2/5e-2 (p rounded to bf16
before the PV product, outputs rounded to bf16).

On the card machine (no JAX there) run the kernel tests alone:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.models import attention as tatt

try:                          # the card's machine has no JAX installed
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import attention as jatt
except ImportError:
    jnp = jops = jatt = None

F32_TOL = (2e-4, 2e-3)
BF16_TOL = (3e-2, 5e-2)

SHAPES = [(2, 128, 2, 64), (1, 257, 3, 32), (1, 64, 1, 128), (2, 96, 4, 16)]
MODES = [(True, 0), (True, 48), (False, 0)]


def _kv_options(h):
    """KV heads to test beside H: MQA (1) and, where it divides H, 2."""
    return sorted({h, 1} | ({2} if h % 2 == 0 else set()))


# (shape, kv heads): every shape at KV = H, 1 and (where it divides) 2
SHAPES_KV = [(shape, kv) for shape in SHAPES + [(4, 1024, 14, 64)]
             for kv in _kv_options(shape[2])]


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


def _qkv(shape, seed, kv=None):
    """q at ``shape``; k/v at ``kv`` heads (default: as many as q)."""
    rng = np.random.default_rng(seed)
    b, s, h, dh = shape
    kv_shape = (b, s, h if kv is None else kv, dh)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in (shape, kv_shape, kv_shape)]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", MODES)
def test_cpu_ops_matches_jax_kernel_f32(shape, causal, window, jax_ref):
    q, k, v = _qkv(shape, 0)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                bq=64, bk=64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got.numpy(), want, F32_TOL)
    _close(got.numpy(), ref.flash_attention(tq, tk, tv, causal=causal,
                                            window=window).numpy(), F32_TOL)


@pytest.mark.parametrize("shape,causal,window", [((1, 128, 2, 64), True, 0),
                                                 ((1, 257, 2, 32), True, 48),
                                                 ((2, 64, 2, 16), False, 0)])
def test_cpu_ops_matches_jax_kernel_bf16(shape, causal, window, jax_ref):
    q, k, v = _qkv(shape, 1)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                bq=64, bk=64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           BF16_TOL)


@pytest.mark.parametrize("s,window", [(160, 0), (200, 48), (40, 0)])
def test_attend_chunked_matches_jax(s, window, jax_ref):
    """The plain chunked path the model holds the kernel against, step
    for step against the reference's jnp ``attend_chunked``."""
    q, k, v = _qkv((1, s, 2, 32), 2)
    want = jatt.attend_chunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window,
                               q_chunk=64, kv_chunk=64)
    got = tatt.attend_chunked(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, window=window, q_chunk=64,
                              kv_chunk=64)
    _close(got.numpy(), want, F32_TOL)


@pytest.mark.parametrize("shape,causal,window",
                         [((2, 130, 4, 32), True, 0),
                          ((1, 257, 4, 16), True, 48),
                          ((2, 64, 4, 64), False, 0)])
@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_ops_kv_heads_match_jax_kernel_expanded(shape, causal, window, kv,
                                                    dtype, jax_ref):
    """``ops.flash_attention`` given K/V at KV heads against the JAX
    kernel given the same K/V expanded by the reference's ``expand_kv``."""
    q, k, v = _qkv(shape, 6, kv=kv)
    h = shape[2]
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want = jops.flash_attention(jq, jatt.expand_kv(jk, h),
                                jatt.expand_kv(jv, h), causal=causal,
                                window=window, bq=64, bk=64)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(dt) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == dt and got.shape == tq.shape
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("s,window", [(40, 0), (160, 0), (200, 48)])
def test_attend_chunked_kv_heads_equals_expanded(kv, s, window):
    """Given fewer heads than q, ``attend_chunked`` (train mode's and the
    plain path's attention) computes exactly what it computes on K/V
    expanded by ``expand_kv``: bit for bit."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, s, 4, 16), 7, kv=kv))
    got = tatt.attend_chunked(q, k, v, causal=True, window=window,
                              q_chunk=64, kv_chunk=64)
    want = tatt.attend_chunked(q, tatt.expand_kv(k, 4), tatt.expand_kv(v, 4),
                               causal=True, window=window, q_chunk=64,
                               kv_chunk=64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv", [1, 2])
def test_ref_kv_heads_equals_expanded(kv):
    """The plain version expands KV heads itself: bit for bit the same as
    given expanded K/V."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 33, 4, 32), 8, kv=kv))
    got = ref.flash_attention(q, k, v, window=8)
    want = ref.flash_attention(q, tatt.expand_kv(k, 4), tatt.expand_kv(v, 4),
                               window=8)
    assert torch.equal(got, want)


def test_cpu_path_launches_no_kernel():
    """A CPU tensor goes to the plain version: nothing is built, the
    launch counter does not move."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 33, 2, 16), 3))
    before = ops.flash_attention.launches
    ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before
    assert "flash_attention" not in build.BUILD_INFO


def test_ops_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 8, 2, 16), 4))
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, k[:, :4], v)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)


@pytest.mark.parametrize("h,kv", [(4, 3), (3, 2), (14, 4)])
def test_ops_rejects_kv_heads_not_dividing_h(h, kv):
    """H % KV != 0 has no head mapping: the wrapper raises."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 8, h, 16), 9, kv=kv))
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError):
        tatt.attend_chunked(q, k, v)


# -- the CUDA kernel on the card ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kv_heads", SHAPES_KV)
@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(shape, kv_heads, causal, window, dtype,
                                      cuda):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in _qkv(shape, 5, kv=kv_heads))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
           F32_TOL if dt == torch.float32 else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 256])
@pytest.mark.parametrize("kv_heads", [1, 2])
def test_kernel_v_layout_on_card(dh, kv_heads, cuda):
    """The PV product reads V (kv rows, Dh) as an MN-major operand (the
    transpose bit of the bf16 wgmma). V whose every element differs by
    row and column, and one-hot attention (a large diagonal score), make
    the output rows copies of V's rows: a transposed or shuffled read
    shows as a wrong copy, not as rounding."""
    b, s, h = 1, 200, 4
    pos = torch.arange(s, device=cuda, dtype=torch.float32)
    col = torch.arange(dh, device=cuda, dtype=torch.float32)
    v = ((pos[:, None] % 61) / 61 - (col[None, :] % 37) / 37)
    v = v[None, :, None, :].expand(b, s, kv_heads, dh).contiguous()
    k = torch.randn((b, s, kv_heads, dh), device=cuda) * 0.05
    k[..., 0] = 40.0                          # every key scores its query
    q = torch.zeros((b, s, h, dh), device=cuda)
    q[..., 0] = 40.0
    # only the diagonal: causal with window 1
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True, window=1)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=True, window=1)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), BF16_TOL)
    expect = v.float()[:, :, [hh // (h // kv_heads) for hh in range(h)]]
    _close(got.float().cpu().numpy(), expect.cpu().numpy(), BF16_TOL)
    # and with every key live (non-causal), against the plain version
    q2, k2, v2 = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                  for x in _qkv((b, s, h, dh), 10, kv=kv_heads))
    _close(ops.flash_attention(q2, k2, v2, causal=False).float().cpu().numpy(),
           ref.flash_attention(q2, k2, v2, causal=False).float().cpu().numpy(),
           BF16_TOL)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_bf16(cuda):
    """The bf16 kernel's TMA maps need 16-byte-aligned bases: a contiguous
    view 2 bytes into its storage raises, nothing is copied."""
    shape = (1, 64, 2, 64)
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, device=cuda, dtype=torch.bfloat16)
    k = buf[1:1 + n].view(shape)
    assert k.is_contiguous() and k.data_ptr() % 16
    q = torch.zeros(shape, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, k, q)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="Dh"):
        ops.flash_attention(q, q, q)


@pytest.mark.cuda
def test_kernel_refuses_autograd(cuda):
    """The kernel has no backward: under autograd with an input that
    requires grad it raises instead of handing back an output with no
    graph (which would zero every attention gradient). Without grad it
    runs."""
    q = torch.randn((1, 8, 2, 64), device=cuda, requires_grad=True)
    k, v = (torch.randn((1, 8, 2, 64), device=cuda) for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == q.shape
