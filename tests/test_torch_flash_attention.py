"""repro_torch flash attention: the port's ``kernels.ops.flash_attention``
held against the JAX reference (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and against the port's plain version, on
the same numpy inputs; plus the CUDA kernel against the plain version on
the card (``cuda`` marker: skipped with a reason where there is none).

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


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


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


# -- the CUDA kernel on the card ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(4, 1024, 14, 64)])
@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(shape, causal, window, dtype, cuda):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in _qkv(shape, 5))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
           F32_TOL if dt == torch.float32 else BF16_TOL)


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
