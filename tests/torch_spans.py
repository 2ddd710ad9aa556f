"""Helpers of the span tests (``test_torch_step_spans.py``,
``test_torch_obs.py``), imported by name: small runs of each
instrumented site of the port on the CPU over a one-peer gloo ring —
TAC and gspmd train steps, an engine group's serve, and a moe serve
step through the expert exchange."""
import torch

from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.serving import chaos, dispatch, engine

DENSE = "qwen2-0.5b-reduced"
MOE = "mixtral-8x7b-reduced"
B, S = 4, 16


def train_run(mode: str = "hadronio", microbatches: int = 2,
              arch: str = DENSE) -> RunConfig:
    return RunConfig(model=get_config(arch),
                     shape=ShapeConfig("t", "train", S, B),
                     comm=CommConfig(mode=mode, slice_bytes=64 * 1024,
                                     channels=4),
                     warmup_steps=1, total_steps=4,
                     microbatches=microbatches)


def batch(step: int, vocab: int) -> dict:
    g = torch.Generator().manual_seed(1000 + step)
    toks = torch.randint(0, vocab, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_steps(run: RunConfig, ring, n: int = 2, mesh=None):
    """``n`` steps from a seeded state: (losses, final state)."""
    state = steps.init_tac_state(torch.Generator().manual_seed(0), run,
                                 "cpu", n_shards=ring.world_size)
    if mesh is not None:
        state = steps.distribute_state(
            state, steps.train_state_shardings(mesh, run))
    step_fn = steps.make_train_step(run, ring, mesh=mesh)
    losses = []
    for k in range(n):
        state, m = step_fn(state, batch(k, run.model.vocab_size))
        losses.append(float(m["loss"]))
    return losses, state


def serve_group(ring, n_requests: int = 6):
    """A hadronio engine group's tokens on ``n_requests`` (more than
    ``max_batch`` 2: the admission path is live) and the group."""
    cfg = get_config(DENSE)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    reqs = chaos.make_requests(n_requests, vocab_size=cfg.vocab_size)
    serve = chaos.chaos_serve_config("hadronio", 1)
    grp = engine.make_engine_group(cfg, params, serve, device="cpu",
                                   ring=ring)
    grp.submit(list(reqs))
    res = grp.run()
    return {r.uid: r.tokens.tolist() for r in res}, grp


def moe_serve(ring):
    """A prefill of 2 rows and one decode step of ``mixtral-8x7b-reduced``
    through the hadronio expert exchange, flushed per channel as the
    serving cells' wire is: (prefill logits, decode logits, layers)."""
    cfg = get_config(MOE)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = dispatch.make_serve_step(
        cfg, CommConfig(mode="hadronio", channels=4, slice_bytes=64 * 1024,
                        aggregate="channel", flush="ready"), ring=ring)
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    lens = torch.tensor([12, 9])
    logits, cache = step.prefill(params, {"tokens": toks,
                                          "last_pos": lens - 1})
    cache = api.grow_cache(cfg, cache, 32)
    dec = {"token": logits.argmax(-1), "pos": lens}
    dlogits, _ = step.decode(params, cache, dec)
    return logits, dlogits, cfg.num_layers
