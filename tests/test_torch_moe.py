"""repro_torch's mixture of experts (``models/moe.py``) against the JAX
reference ``repro.models.moe`` on the CPU, f32:

* ``capacity`` at S in {1, 128, 1024, 4090} for the full and reduced
  moe configs;
* ``_ranks_within_expert`` bitwise on random and heavily skewed expert
  ids;
* ``apply_moe`` output and aux loss for ``mixtral-8x7b-reduced`` and
  ``dbrx-132b-reduced`` (atol = rtol = 1e-4: the frameworks sum in other
  orders), a dropping case (capacity factor 1.25, a router biased to one
  expert: the same entries drop), and a tie case (duplicated router
  columns: the same experts are chosen as by ``jax.lax.top_k``, lower
  index first);
* ``apply_experts`` on a slice of the expert axis equals that slice of
  the whole.

The params are the JAX init plus seeded numpy noise on every leaf,
converted with ``models/convert``. On the card (``cuda`` marker) the
routing runs with no host sync and matches the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import TOL, close

from repro_torch.configs.registry import get_config
from repro_torch.models import moe
from repro_torch.models.convert import from_numpy_params

try:                          # the card's machine has no JAX installed
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_config
    from repro.models import moe as jmoe
except ImportError:
    jax = None

ARCHS = ("mixtral-8x7b-reduced", "dbrx-132b-reduced")


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _pair(arch, seed=0, **moe_kw):
    """(jax cfg, port cfg, jax moe params, port moe params, x numpy)."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_kw))
    rng = np.random.default_rng(seed)
    d, f, e = tcfg.d_model, tcfg.d_ff, tcfg.moe.num_experts
    p = {"router": rng.normal(scale=0.3, size=(d, e)),
         "wi": rng.normal(scale=0.1, size=(e, d, f)),
         "wg": rng.normal(scale=0.1, size=(e, d, f)),
         "wo": rng.normal(scale=0.1, size=(e, f, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return jcfg, tcfg, p


def _run_both(jcfg, tcfg, p, x):
    jout, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tout, taux = moe.apply_moe(from_numpy_params(p, "cpu"),
                               torch.from_numpy(x), tcfg)
    return (np.asarray(jout), float(jaux)), (tout, float(taux))


@pytest.mark.parametrize("arch", ARCHS + ("mixtral-8x7b", "dbrx-132b"))
@pytest.mark.parametrize("s", [1, 128, 1024, 4090])
def test_capacity_matches_jax(jax_ref, arch, s):
    got = moe.capacity(s, get_config(arch))
    assert got == jmoe.capacity(s, jax_config(arch))
    assert got % 16 == 0 and got >= 16


def _eids(kind, b=3, n=200, e=8):
    rng = np.random.default_rng(3)
    if kind == "random":
        return rng.integers(0, e, (b, n)).astype(np.int32)
    # heavily skewed: ~90% of the entries on expert 5, the rest spread
    out = np.where(rng.random((b, n)) < 0.9, 5, rng.integers(0, e, (b, n)))
    out[0] = 2                                 # one row on a single expert
    return out.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_ranks_within_expert_bitwise(jax_ref, kind):
    eids = _eids(kind)
    want = np.asarray(jmoe._ranks_within_expert(jnp.asarray(eids)))
    got = moe._ranks_within_expert(torch.from_numpy(eids).long())
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "skewed":
        assert got[0].tolist() == list(range(eids.shape[1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(jax_ref, arch):
    jcfg, tcfg, p = _pair(arch)
    x = np.random.default_rng(1).normal(size=(2, 24, tcfg.d_model)).astype(
        np.float32)
    (jout, jaux), (tout, taux) = _run_both(jcfg, tcfg, p, x)
    assert tout.shape == x.shape
    close(tout, jout, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)


def test_apply_moe_drops_as_jax(jax_ref):
    """Capacity factor 1.25 (the full configs' value) and a router that
    sends every token's first choice to expert 0: 2 x 64 entries
    compete for 48 slots per row, and the same ones drop."""
    jcfg, tcfg, p = _pair("mixtral-8x7b-reduced", capacity_factor=1.25)
    p["router"][:, 0] += 0.5
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 64, tcfg.d_model)) + 1.0).astype(np.float32)
    c = moe.capacity(64, tcfg)
    assert c == 48
    logits = x @ p["router"]
    jidx = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)),
                                    2)[1]).reshape(2, -1)
    jrank = np.asarray(jmoe._ranks_within_expert(jnp.asarray(jidx)))
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    tidx = moe.top_k(probs, 2)[1].reshape(2, -1)
    trank = moe._ranks_within_expert(tidx)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    dropped = trank.numpy() >= c
    np.testing.assert_array_equal(dropped, jrank >= c)
    assert (jidx[:, ::2] == 0).all() and dropped.sum() == 2 * (64 - c)
    (jout, jaux), (tout, taux) = _run_both(jcfg, tcfg, p, x)
    close(tout, jout, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)


def test_top_k_ties_pick_the_lower_index(jax_ref):
    """Duplicated router columns give equal probabilities; the chosen
    experts are ``lax.top_k``'s (the lower index of a tie first), and so
    is the moe output."""
    jcfg, tcfg, p = _pair("dbrx-132b-reduced")
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, 3] = p["router"][:, 2]
    x = np.random.default_rng(4).normal(size=(2, 16, tcfg.d_model)).astype(
        np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
        p["router"]), dim=-1)
    assert torch.equal(probs[..., 0], probs[..., 1]) \
        and torch.equal(probs[..., 2], probs[..., 3])
    jprobs = jnp.asarray(probs.numpy())
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jprobs, k)
        tv, ti = moe.top_k(probs, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # every first choice is the lower index of its tied pair
    assert set(moe.top_k(probs, 1)[1].unique().tolist()) <= {0, 2}
    (jout, jaux), (tout, taux) = _run_both(jcfg, tcfg, p, x)
    close(tout, jout, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)


def test_apply_experts_on_a_slice_equals_the_whole():
    cfg = get_config("dbrx-132b-reduced")
    _, _, p = _pair("dbrx-132b-reduced")
    tp = from_numpy_params(p, "cpu")
    buf = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 4, 16, cfg.d_model)).astype(np.float32))
    whole = moe.apply_experts(tp, buf, cfg)
    for lo in (0, 2):
        part = moe.apply_experts({w: tp[w][lo:lo + 2] for w in
                                  ("wi", "wg", "wo")},
                                 buf[:, lo:lo + 2].contiguous(), cfg)
        assert torch.equal(part, whole[:, lo:lo + 2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_on_card_matches_cpu(arch, cuda):
    """f32 on the card against the CPU (TF32 off), and no host sync
    while routing, dispatching and combining."""
    cfg = get_config(arch)
    _, _, p = _pair(arch)
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    want, want_aux = moe.apply_moe(from_numpy_params(p, "cpu"),
                                   torch.from_numpy(x), cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gp = from_numpy_params(p, cuda)
        gx = torch.from_numpy(x).to(cuda)
        torch.cuda.set_sync_debug_mode("error")
        got, aux = moe.apply_moe(gp, gx, cfg)
        torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    close(got.cpu(), want, 1e-5, 1e-5)
    close(aux.cpu(), want_aux, 1e-6, 1e-6)
