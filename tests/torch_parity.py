"""Helpers the port's JAX-parity tests share (``tests/test_torch_*.py``):
the same numbers through the JAX reference and through ``repro_torch``.
JAX is imported only where it is installed (the card's machine has
none); the card-only tests need nothing from here but ``close``."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import CommConfig, ServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.models.common import tree_paths
from repro_torch.models.convert import from_numpy_params
from repro_torch.serving import Request, make_engine_group

try:
    import jax
    import jax.numpy as jnp
    from repro.configs.base import CommConfig as JCommConfig
    from repro.configs.base import ServeConfig as JServeConfig
    from repro.configs.registry import get_config as jax_config
    from repro.models import api as japi
    from repro.serving import Request as JRequest
    from repro.serving import make_engine_group as jax_group
except ImportError:
    jax = None

TOL = dict(atol=1e-4, rtol=1e-4)


def close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def noisy(tree, seed, scale=0.05):
    """Every leaf of a JAX param tree plus N(0, scale^2) numpy noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        scale=scale, size=np.shape(a)).astype(np.float32), tree)


def model_pair(arch, seed=0, **replace):
    """(jax cfg, port cfg, jax params, port params) on the same numbers."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    jp = noisy(japi.init(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), from_numpy_params(
        jp, "cpu")


def assert_trees_close(tc, jc, tol=TOL):
    jl = {".".join(str(k.key) for k in path): leaf for path, leaf in
          jax.tree_util.tree_flatten_with_path(jc)[0]}
    tl = dict(tree_paths(tc))
    assert sorted(tl) == sorted(jl)
    for path, leaf in tl.items():
        assert tuple(leaf.shape) == tuple(jl[path].shape), path
        close(leaf.float(), jl[path], **tol)


def teacher_forced(jcfg, tcfg, jp, tp, toks, steps, seed):
    """Prefill, then ``steps`` decode steps fed the same numpy tokens;
    yields (jax logits, jax cache, port logits, port cache) each time."""
    rng = np.random.default_rng(seed)
    jpre = jax.jit(lambda p, b: japi.prefill(p, b, jcfg))
    jdec = jax.jit(lambda p, c, b: japi.decode_step(p, c, b, jcfg))
    jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = api.prefill(tp, {"tokens": torch.as_tensor(toks).long()}, tcfg)
    yield jl, jc, tl, tc
    pos = np.full((toks.shape[0],), toks.shape[1], np.int32)
    for _ in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, toks.shape[0]).astype(np.int32)
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(tok),
                               "pos": jnp.asarray(pos)})
        tl, tc = api.decode_step(tp, tc, {"token": torch.as_tensor(tok).long(),
                                          "pos": torch.as_tensor(pos).long()},
                                 tcfg)
        yield jl, jc, tl, tc
        pos = pos + 1


def requests(lens, max_new, seed):
    """(uid, prompt, max_new) triples; prompt tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, size=n), max_new[i % len(max_new)])
            for i, n in enumerate(lens)]


def served_tokens(jcfg, tcfg, jp, tp, reqs, event_loops=2, max_len=48):
    """Greedy tokens of the JAX group and of the port's group, by uid."""
    kw = dict(event_loops=event_loops, poll="busy", max_batch=2,
              max_len=max_len)
    jg = jax_group(jcfg, jp, JServeConfig(comm=JCommConfig(mode="gspmd"),
                                          **kw))
    jg.submit([JRequest(u, p, max_new=m) for u, p, m in reqs])
    tg = make_engine_group(tcfg, tp, ServeConfig(comm=CommConfig(
        mode="gspmd"), **kw), device="cpu")
    tg.submit([Request(u, p, max_new=m) for u, p, m in reqs])
    out = []
    for g in (jg, tg):
        res = sorted(g.run(threads=True), key=lambda r: r.uid)
        out.append([tuple(r.tokens.tolist()) for r in res])
    return out[0], out[1], tg
