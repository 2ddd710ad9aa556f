"""Train-step builders of the port.

Counterpart of ``repro/launch/steps.py`` (its train steps; the serve
steps live in ``serving/dispatch.py``). Two step families, picked by the
backend's ``manual`` flag, never by a mode name:

* TAC (every backend with ``manual=True``) — the paper's regime: each
  process is one data-parallel peer of the ring. The local loss is
  scaled by 1/ring size, autograd gives the local gradients,
  ``tac.sync_grads`` sums them over the ring through the backend's
  collective schedule, and the backend's ``apply_update`` turns the sum
  into an update (for the ``zero1`` backends: this peer's flat shard,
  then the gather epilogue). The state layout is the backend's
  ``state_specs``. The reference runs this body inside a manual
  ``shard_map`` and its state carries a leading ring dim; here the
  process *is* the peer and holds its own row.
* gspmd (``manual=False``) — local gradients and a tree AdamW with no
  exchange, on one peer only (a wider ring needs FSDP2/DTensor,
  ROADMAP.md Queue 1 item 8).

Both families accumulate gradients over ``run.microbatches`` sequential
microbatches (``_accumulate_grads``), as the reference does: one
microbatch gives the gradients in the parameter dtype, more give their
f32 mean. The exchange runs once per step, after the accumulation.

A step is ``step_fn(state, batch) -> (state, metrics)`` with ``batch``
{"tokens", "labels"} on the device; metrics are 0-d tensors plus the
Python float ``lr``. A step built with ``donate=True`` consumes the
state it is given, as the reference's ``Trainer`` donates its state to
the jitted step: the tree AdamW writes the new params and moments into
that state's tensors, so one copy of them lives instead of two (the
ZeRO-1 backends' flat update still makes new shards). The caller must
not read the given state again. ``abstract_state`` is the state's layout as
``meta`` tensors (the ``like`` tree of a checkpoint restore) and
``ring_rows`` names the checkpoint leaves each peer holds one row of.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import RunConfig
from repro_torch.core import tac
from repro_torch.core.backends import (UpdateContext, get_backend,
                                       scatter_group_size)
from repro_torch.core.backends.base import EF
from repro_torch.core.channels import Ring
from repro_torch.models import api
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.optim import adamw

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: adamw.AdamState          # tree moments, or this peer's flat
    #                               ZeRO-1 shards (zero1 backends)
    step: int
    ef: EF = None                 # this peer's error-feedback residual: a
    #                               tensor keyed to the ring plan, or a
    #                               tuple keyed by bucket id


def _loss_and_grads(params: Tree, batch: dict, run: RunConfig,
                    n_shards: int):
    """(loss / n_shards, its grads) by autograd over fresh leaves that
    alias the params. ``backward`` frees the graph before this returns."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _aux = api.loss(leaves, batch, run.model)
        loss = loss / n_shards
        loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, leaves)


def _microbatches(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) for gradient accumulation (views)."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split into {n} "
                             "microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def _accumulate_grads(params: Tree, batch: dict, run: RunConfig,
                      n_shards: int):
    """Mean loss and grads over ``run.microbatches`` sequential
    microbatches. One microbatch returns the grads in the parameter
    dtype; more sum them in f32 (``acc + g.float()`` from zeros, then
    ``x 1/n``, the reference's order) and return f32. Each microbatch's
    graph is freed by its backward before the next forward, so peak
    memory falls with ``n``."""
    n = run.microbatches
    if n == 1:
        return _loss_and_grads(params, batch, run, n_shards)
    micro = _microbatches(batch, n)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    for i in range(n):
        loss, grads = _loss_and_grads(
            params, {k: v[i] for k, v in micro.items()}, run, n_shards)
        for (_, a), (_, g) in zip(tree_paths(acc), tree_paths(grads)):
            a.add_(g)
        lsum = lsum + loss
        del grads
    inv = 1.0 / n
    return lsum * inv, tree_map(lambda a: a.mul_(inv), acc)


def init_train_state(gen: torch.Generator, run: RunConfig,
                     device: DeviceLike = None) -> TrainState:
    params = api.init(gen, run.model, device=device)
    return TrainState(params=params, opt=adamw.init(params), step=0)


def init_tac_state(gen: torch.Generator, run: RunConfig,
                   device: DeviceLike = None, *,
                   n_shards: int = 1) -> TrainState:
    """Params from ``gen``; moments and error feedback laid out as the
    backend's ``state_specs`` say for a ring of ``n_shards`` peers,
    zero-filled on ``device``."""
    dev = resolve_device(device)
    return tac_state(api.init(gen, run.model, device=dev), run,
                     n_shards=n_shards)


def tac_state(params: Tree, run: RunConfig, *,
              n_shards: int = 1) -> TrainState:
    """A step-0 TAC state around ``params``: moments and error feedback
    laid out as the backend's ``state_specs`` say for a ring of
    ``n_shards`` peers, zero-filled on the params' device."""
    dev = tree_paths(params)[0][1].device
    specs = get_backend(run.comm.mode).state_specs(run, n_shards)
    zeros = lambda m: torch.zeros(m.shape, dtype=m.dtype, device=dev)
    ef = specs.ef
    if ef is not None:
        ef = tuple(map(zeros, ef)) if isinstance(ef, tuple) else zeros(ef)
    return TrainState(params=params,
                      opt=adamw.AdamState(tree_map(zeros, specs.opt.mu),
                                          tree_map(zeros, specs.opt.nu), 0),
                      step=0, ef=ef)


def abstract_state(run: RunConfig, n_shards: int = 1) -> TrainState:
    """The state's layout for a ring of ``n_shards`` peers, as ``meta``
    tensors (no storage): params in their dtype, moments and error
    feedback as the backend's ``state_specs`` say (this peer's row of
    the ring-sharded leaves). The ``like`` tree of a checkpoint restore;
    the counterpart of the reference's ``abstract_tac_state`` and
    ``abstract_train_state``."""
    dtype = torch_dtype(run.model.param_dtype)
    params = tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                            device="meta"),
                      api.specs(run.model))
    specs = get_backend(run.comm.mode).state_specs(run, n_shards)
    return TrainState(params=params, opt=specs.opt, step=0, ef=specs.ef)


def ring_rows(name: str) -> bool:
    """Whether the checkpoint leaf ``name`` (the reference's file name,
    ``checkpoint.store.leaf_files``) is one that each peer holds one row
    of: every error-feedback leaf, and the moments when they are ZeRO-1
    flat shards (a tree of moments has longer names). The reference's
    state stacks these rows along a leading ring dim."""
    return name.startswith(".ef") or name in (".opt_.mu.npy",
                                              ".opt_.nu.npy")


def make_train_step_tac(run: RunConfig, ring: Ring, *,
                        donate: bool = False):
    """The TAC step over ``ring``: every process runs it on its own
    shard of the global batch."""
    comm = run.comm
    backend = get_backend(comm.mode)
    backend.validate(comm)
    n_shards = ring.world_size
    uctx = UpdateContext(ring=ring, eff_shards=scatter_group_size(
        n_shards, 1, comm), donate=donate)

    def step_fn(state: TrainState, batch: dict):
        # local loss scaled so the ring sum of the grads is the global mean
        loss, grads = _accumulate_grads(state.params, batch, run, n_shards)
        res = tac.sync_grads(grads, comm, ring=ring, ef=state.ef)
        del grads       # the local gradients are dead once synced
        # the loss epilogue after the sync emission, as in the reference
        dist.all_reduce(loss, group=ring.group)
        new_params, new_opt, metrics = backend.apply_update(
            state.params, state.opt, res, run, uctx)
        return TrainState(new_params, new_opt, state.step + 1,
                          res.ef), dict(metrics, loss=loss)

    return step_fn


def make_train_step_gspmd(run: RunConfig, ring: Ring, *,
                          donate: bool = False):
    """Local gradients and a tree AdamW, no exchange: one peer only."""
    if ring.world_size != 1:
        raise NotImplementedError(
            f"gspmd training over a ring of {ring.world_size} peers needs "
            "FSDP2/DTensor, which is not ported yet (ROADMAP.md Queue 1 "
            "item 8); use a TAC mode such as hadronio")

    def step_fn(state: TrainState, batch: dict):
        loss, grads = _accumulate_grads(state.params, batch, run, 1)
        new_params, new_opt, metrics = adamw.update(
            grads, state.opt, state.params, run, inplace=donate)
        return TrainState(new_params, new_opt, state.step + 1,
                          state.ef), dict(metrics, loss=loss)

    return step_fn


def make_train_step(run: RunConfig, ring: Ring, *, donate: bool = False):
    """Dispatch on the registered backend's step family (callers never
    change, and no mode names appear here). ``donate``: the step
    consumes its state (module docstring)."""
    backend = get_backend(run.comm.mode)
    backend.validate(run.comm)
    if backend.manual:
        return make_train_step_tac(run, ring, donate=donate)
    return make_train_step_gspmd(run, ring, donate=donate)
