"""Step builders of the port.

Counterpart of ``repro/launch/steps.py``: its train steps, and its
GSPMD serve steps (``make_prefill_step``, ``make_decode_step``,
``serve_specs``; the ring serve step of the comm backends is
``serving/dispatch.py``'s ``ServeStep``). Two train step families,
picked by the backend's ``manual`` flag, never by a mode name:

* TAC (every backend with ``manual=True``) — the paper's regime: each
  process is one data-parallel peer of the ring. The local loss is
  scaled by 1/ring size, autograd gives the local gradients,
  ``tac.sync_grads`` sums them over the ring through the backend's
  collective schedule, and the backend's ``apply_update`` turns the sum
  into an update (for the ``zero1`` backends: this peer's flat shard,
  then the gather epilogue). The state layout is the backend's
  ``state_specs``. The reference runs this body inside a manual
  ``shard_map`` and its state carries a leading ring dim; here the
  process *is* the peer and holds its own row. A ring with pods (the
  reference's mesh with a ``pod`` axis, every axis flattened pod-major:
  ``launch/mesh.make_ring``) makes the collectives pod-aware under
  ``comm.hierarchical`` and the ZeRO-1 scatter group in-pod
  (``backends.scatter_group_size``), as the reference's TAC body.
* gspmd (``manual=False``) — the production 2-D sharded step over a
  ``DeviceMesh`` (``launch/mesh.make_device_mesh``): params and AdamW
  moments are DTensors at ``launch/sharding.param_shardings`` (FSDP over
  ``data``, TP over ``model``), the global batch is placed at
  ``batch_sharding``, ``api.loss`` runs with ``make_shard_fn(mesh)``'s
  activation constraints (SP), and DTensor's sharding propagation owns
  every collective, as XLA's GSPMD does in the reference. Plain tensors
  inside the model (positions, masks, softmax state) join DTensor ops as
  replicated values (``implicit_replication``). The gradients arrive
  ``Partial`` or at whatever placement the backward left them, and are
  redistributed to their param's placements before the tree AdamW, which
  updates each DTensor's local block with the global norm taken over the
  whole tree. Without a mesh the step is one peer's local step on plain
  tensors, as before. Every family's ``shard_fn`` sites are threaded
  (``GSPMD_FAMILIES``), so every family trains over a mesh. The
  recurrent families' train mode runs its plain scans on each peer's
  local blocks (``rwkv6.scan_blocks``, ``hybrid.scan_blocks``); the moe
  family's routing and combine run on each peer's rows
  (``models/moe``), its experts split over ``model``; an encdec batch
  carries its ``"frames"`` at ``batch_sharding``.

The GSPMD serve steps run ``api.prefill`` and ``api.decode_step`` over
a mesh the same way, whatever the comm mode (the reference's dry run
lowers every prefill and decode cell through them): params at
``param_shardings`` (FSDP), the inputs at ``batch_sharding``, the decode
cache at ``cache_shardings`` (``serve_specs`` gives the six layouts;
``launch/sharding.distribute_tree`` places full trees at them), and
``make_shard_fn(mesh)``'s constraints. Prefill attention runs the flash
kernel on each peer's local blocks (``transformer.attend_blocks``;
whisper's encoder non-causal), and so do the recurrent scans (WKV6,
RG-LRU) in prefill and decode; a
decode step writes the new K/V into the given cache in place, at its
own placement, and returns that cache object, as the reference's
``out_shardings=(None, cache_shardings)`` returns it at its layout. A
recurrent family's state is new each step (``RECURRENT_FAMILIES``): the
prefill and every decode step return it redistributed to
``cache_shardings``, since the scans leave it at their own (batch,
heads) or (batch, lru) blocks.

Both families accumulate gradients over ``run.microbatches`` sequential
microbatches (``_accumulate_grads``), as the reference does: one
microbatch gives the gradients in the parameter dtype, more give their
f32 mean. The exchange runs once per step, after the accumulation.

Telemetry (``obs/trace.py``), when tracing is on: a ``step`` span
around each step as the host issues it, ``forward`` around each
microbatch's loss, ``backward`` around autograd's backward (the
stacked-parameter gradient adds inside it included) and ``update``
around the optimizer update (clipping and AdamW; the TAC backend's
``apply_update``). The f32 accumulation, the exchange's own spans
(``emission`` / ``stage`` / ``flush``) and the loss all-reduce sit
directly inside ``step``. Off, each site costs one ``None`` check.

A step is ``step_fn(state, batch) -> (state, metrics)`` with ``batch``
{"tokens", "labels"} on the device (the gspmd step over a mesh takes the
global batch, the same on every peer); metrics are 0-d
tensors plus the Python float ``lr``. A step built with ``donate=True``
consumes the state it is given, as the reference's ``Trainer`` donates
its state to the jitted step: the tree AdamW writes the new params and
moments into that state's tensors, so one copy of them lives instead of
two (the ZeRO-1 backends' flat update still makes new shards). The
caller must not read the given state again. ``abstract_state`` is the
state's layout as ``meta`` tensors (the ``like`` tree of a checkpoint
restore, with ``train_state_shardings`` as its placements over a mesh)
and ``ring_rows`` names the checkpoint leaves each peer holds one row
of.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.compat import DeviceLike, resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import tac
from repro_torch.core.backends import (UpdateContext, get_backend,
                                       scatter_group_size)
from repro_torch.core.backends.base import EF
from repro_torch.core.channels import Ring
from repro_torch.launch.sharding import (Sharding, batch_sharding,
                                         cache_shardings, distribute_tree,
                                         make_shard_fn, param_shardings)
from repro_torch.models import api
from repro_torch.models.common import tree_map, tree_paths
from repro_torch.models.layers import ShardFn, no_shard
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw

# families whose shard_fn sites are threaded: they train and serve gspmd
# over a mesh (every registered family)
GSPMD_FAMILIES = ModelConfig.FAMILIES
# families whose decode state is returned new each step (a recurrent
# state), not written in place: the serve steps place it at
# cache_shardings
RECURRENT_FAMILIES = ("ssm", "hybrid")

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt: adamw.AdamState          # tree moments, or this peer's flat
    #                               ZeRO-1 shards (zero1 backends)
    step: int
    ef: EF = None                 # this peer's error-feedback residual: a
    #                               tensor keyed to the ring plan, or a
    #                               tuple keyed by bucket id


def _at_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient at its param's placements (a ``Partial`` one is
    reduced, reduce-scattered onto a sharded param); a plain one as it
    is."""
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _scaled_loss(leaves: Tree, batch: dict, run: RunConfig, n_shards: int,
                 shard_fn: ShardFn) -> torch.Tensor:
    loss, _aux = api.loss(leaves, batch, run.model, shard_fn)
    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
    return loss / n_shards


def _loss_and_grads(params: Tree, batch: dict, run: RunConfig,
                    n_shards: int, shard_fn: ShardFn = no_shard,
                    index: int = 0):
    """(loss / n_shards, its grads) by autograd over fresh leaves that
    alias the params. ``backward`` frees the graph before this returns.
    DTensor params give a plain loss (the global value on every peer)
    and gradients at the params' placements. ``index`` is the
    microbatch's, for the ``forward`` and ``backward`` spans."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        if obs_trace.enabled():
            with obs_trace.span("forward", f"mb{index}", microbatch=index):
                loss = _scaled_loss(leaves, batch, run, n_shards, shard_fn)
            with obs_trace.span("backward", f"mb{index}", microbatch=index):
                loss.backward()
        else:
            loss = _scaled_loss(leaves, batch, run, n_shards, shard_fn)
            loss.backward()
    return loss.detach(), tree_map(lambda p: _at_param(p.grad, p), leaves)


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
                      n_shards: int, shard_fn: ShardFn = no_shard,
                      mesh: Optional[DeviceMesh] = None):
    """Mean loss and grads over ``run.microbatches`` sequential
    microbatches. One microbatch returns the grads in the parameter
    dtype; more sum them in f32 (``acc + g.float()`` from zeros, then
    ``x 1/n``, the reference's order) and return f32. Each microbatch's
    graph is freed by its backward before the next forward, so peak
    memory falls with ``n``. With a ``mesh`` the batch is global and
    each microbatch (its rows ``i·B/n`` onwards, as the reference's
    reshape takes them) is placed at ``batch_sharding``."""
    n = run.microbatches
    place = (lambda b: b) if mesh is None else (lambda b: _placed(b, mesh))
    if n == 1:
        return _loss_and_grads(params, place(batch), run, n_shards, shard_fn)
    micro = _microbatches(batch, n)
    acc = tree_map(adamw.zeros_f32, params)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    for i in range(n):
        loss, grads = _loss_and_grads(
            params, place({k: v[i] for k, v in micro.items()}), run,
            n_shards, shard_fn, i)
        for (_, a), (_, g) in zip(tree_paths(acc), tree_paths(grads)):
            a.add_(g)
        lsum = lsum + loss
        del grads
    inv = 1.0 / n
    return lsum * inv, tree_map(lambda a: a.mul_(inv), acc)


def _placed(batch: dict, mesh: DeviceMesh) -> dict:
    """The global batch (the same on every peer) at ``batch_sharding``."""
    return distribute_tree(batch, batch_sharding(mesh, batch))


def init_train_state(gen: torch.Generator, run: RunConfig,
                     device: DeviceLike = None) -> TrainState:
    params = api.init(gen, run.model, device=device)
    return TrainState(params=params, opt=adamw.init(params), step=0)


def abstract_train_state(run: RunConfig) -> TrainState:
    """The gspmd state's layout as ``meta`` tensors (no storage): params
    in their dtype, f32 tree moments."""
    specs = get_backend("gspmd").state_specs(run, 1)
    return TrainState(params=api.abstract(run.model), opt=specs.opt, step=0)


def train_state_shardings(mesh, run: RunConfig, *,
                          fsdp: bool = True) -> TrainState:
    """``launch/sharding.Sharding`` tree matching
    :func:`abstract_train_state`: params and both moments at
    ``param_shardings``, the counters replicated."""
    ps = param_shardings(mesh, api.specs(run.model), fsdp=fsdp)
    scalar = Sharding(mesh, ())
    return TrainState(params=ps,
                      opt=adamw.AdamState(mu=ps, nu=ps, count=scalar),
                      step=scalar)


def distribute_state(state: TrainState, shardings: TrainState) -> TrainState:
    """A full gspmd state (the same on every peer) placed at
    ``shardings``: params and moments as DTensors (this peer's blocks,
    no collective), the counters as they are."""
    return TrainState(
        params=distribute_tree(state.params, shardings.params),
        opt=adamw.AdamState(distribute_tree(state.opt.mu, shardings.opt.mu),
                            distribute_tree(state.opt.nu, shardings.opt.nu),
                            state.opt.count),
        step=state.step, ef=state.ef)


def uses_dtensor(run: RunConfig, mesh: Optional[DeviceMesh]) -> bool:
    """Whether ``run`` trains on DTensors over ``mesh``: a gspmd run with
    a mesh (every family's sites are threaded: ``GSPMD_FAMILIES``)."""
    return mesh is not None and not get_backend(run.comm.mode).manual


def init_tac_state(gen: torch.Generator, run: RunConfig,
                   device: DeviceLike = None, *, n_shards: int = 1,
                   pod_size: int = 1) -> TrainState:
    """Params from ``gen``; moments and error feedback laid out as the
    backend's ``state_specs`` say for a ring of ``n_shards`` peers in
    ``pod_size`` pods (the pod axis's size), zero-filled on
    ``device``."""
    dev = resolve_device(device)
    return tac_state(api.init(gen, run.model, device=dev), run,
                     n_shards=n_shards, pod_size=pod_size)


def tac_state(params: Tree, run: RunConfig, *, n_shards: int = 1,
              pod_size: int = 1) -> TrainState:
    """A step-0 TAC state around ``params``: moments and error feedback
    laid out as the backend's ``state_specs`` say for a ring of
    ``n_shards`` peers in ``pod_size`` pods, zero-filled on the params'
    device."""
    dev = tree_paths(params)[0][1].device
    specs = get_backend(run.comm.mode).state_specs(run, n_shards, pod_size)
    zeros = lambda m: torch.zeros(m.shape, dtype=m.dtype, device=dev)
    ef = specs.ef
    if ef is not None:
        ef = tuple(map(zeros, ef)) if isinstance(ef, tuple) else zeros(ef)
    return TrainState(params=params,
                      opt=adamw.AdamState(tree_map(zeros, specs.opt.mu),
                                          tree_map(zeros, specs.opt.nu), 0),
                      step=0, ef=ef)


def abstract_state(run: RunConfig, n_shards: int = 1,
                   pod_size: int = 1) -> TrainState:
    """The state's layout for a ring of ``n_shards`` peers in
    ``pod_size`` pods, as ``meta`` tensors (no storage): params in their
    dtype, moments and error feedback as the backend's ``state_specs``
    say (this peer's row of the ring-sharded leaves). The ``like`` tree
    of a checkpoint restore and the dry run's state; the counterpart of
    the reference's ``abstract_tac_state`` and
    ``abstract_train_state``."""
    dtype = torch_dtype(run.model.param_dtype)
    params = tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                            device="meta"),
                      api.specs(run.model))
    specs = get_backend(run.comm.mode).state_specs(run, n_shards, pod_size)
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
    shard of the global batch. The ring's pods (``ring.pods``) size the
    ZeRO-1 scatter group; its state comes from ``tac_state`` /
    ``abstract_state`` at the same ring size and pod count."""
    comm = run.comm
    backend = get_backend(comm.mode)
    backend.validate(comm)
    n_shards = ring.world_size
    uctx = UpdateContext(ring=ring, eff_shards=scatter_group_size(
        n_shards, ring.pods, comm), donate=donate)

    def body(state: TrainState, batch: dict):
        # local loss scaled so the ring sum of the grads is the global mean
        loss, grads = _accumulate_grads(state.params, batch, run, n_shards)
        res = tac.sync_grads(grads, comm, ring=ring, ef=state.ef)
        del grads       # the local gradients are dead once synced
        # the loss epilogue after the sync emission, as in the reference
        dist.all_reduce(loss, group=ring.group)
        if obs_trace.enabled():
            with obs_trace.span("update", "apply_update", mode=comm.mode):
                new_params, new_opt, metrics = backend.apply_update(
                    state.params, state.opt, res, run, uctx)
        else:
            new_params, new_opt, metrics = backend.apply_update(
                state.params, state.opt, res, run, uctx)
        return TrainState(new_params, new_opt, state.step + 1,
                          res.ef), dict(metrics, loss=loss)

    return _traced_step(body)


def make_train_step_gspmd(run: RunConfig,
                          mesh: Optional[DeviceMesh] = None, *,
                          donate: bool = False):
    """The gspmd step over ``mesh`` (a ``DeviceMesh``; its state from
    :func:`distribute_state` at :func:`train_state_shardings`), or one
    peer's local step on plain tensors when ``mesh`` is None (or the
    run's mode is a TAC one: ``uses_dtensor``)."""
    if not uses_dtensor(run, mesh):
        mesh = None
    shard_fn = make_shard_fn(mesh)

    def body(state: TrainState, batch: dict):
        with implicit_replication():
            loss, grads = _accumulate_grads(state.params, batch, run, 1,
                                            shard_fn, mesh)
            if obs_trace.enabled():
                with obs_trace.span("update", "adamw", mode="gspmd"):
                    new_params, new_opt, metrics = adamw.update(
                        grads, state.opt, state.params, run, inplace=donate)
            else:
                new_params, new_opt, metrics = adamw.update(
                    grads, state.opt, state.params, run, inplace=donate)
        return TrainState(new_params, new_opt, state.step + 1,
                          state.ef), dict(metrics, loss=loss)

    return _traced_step(body)


def _traced_step(body):
    """``body`` as a step, under a ``step`` span when tracing is on."""
    def step_fn(state: TrainState, batch: dict):
        if not obs_trace.enabled():
            return body(state, batch)
        with obs_trace.span("step", f"step{state.step}", step=state.step):
            return body(state, batch)

    return step_fn


def make_train_step(run: RunConfig, ring: Optional[Ring] = None, *,
                    mesh: Optional[DeviceMesh] = None,
                    donate: bool = False):
    """Dispatch on the registered backend's step family (callers never
    change, and no mode names appear here): a TAC step over ``ring``, or
    the gspmd step over ``mesh`` (None: one peer). ``donate``: the step
    consumes its state (module docstring)."""
    backend = get_backend(run.comm.mode)
    backend.validate(run.comm)
    if backend.manual:
        return make_train_step_tac(run, ring, donate=donate)
    if mesh is None and ring is not None and ring.world_size > 1:
        raise ValueError(
            f"gspmd over {ring.world_size} peers runs on a DeviceMesh "
            "(launch/mesh.make_device_mesh), not a ring: pass mesh=")
    return make_train_step_gspmd(run, mesh, donate=donate)


# ---------------------------------------------------------------------------
# Serve steps (GSPMD)
# ---------------------------------------------------------------------------


def _state_placer(run: RunConfig, mesh: Optional[DeviceMesh]):
    """The serve steps' last move: a recurrent family's new state (and
    the hybrid's attention pages) over a mesh redistributed to
    ``cache_shardings``, the reference's ``out_shardings``; the identity
    for the other families (their decode cache is written in place at
    its placement and comes back as the given object) and off a mesh."""
    if mesh is None or run.model.family not in RECURRENT_FAMILIES:
        return lambda cache: cache
    return lambda cache: tree_map(
        lambda t, sh: t.redistribute(mesh, sh.placements), cache,
        cache_shardings(mesh, cache))


def make_prefill_step(run: RunConfig, mesh: Optional[DeviceMesh] = None):
    """``prefill_fn(params, batch) -> (last-token logits, cache)`` over
    ``mesh`` (params, batch as DTensors at ``serve_specs``'
    layouts), or one peer's plain prefill when ``mesh`` is None. A
    recurrent family's cache comes back at ``cache_shardings``."""
    cfg = run.model
    shard_fn = make_shard_fn(mesh)
    place = _state_placer(run, mesh)

    def prefill_fn(params, batch):
        with implicit_replication():
            logits, cache = api.prefill(params, batch, cfg, shard_fn)
            return logits, place(cache)

    return prefill_fn


def make_decode_step(run: RunConfig, mesh: Optional[DeviceMesh] = None):
    """``decode_fn(params, cache, batch) -> (logits, cache)``: one new
    token against a KV cache (the ``serve_step``), written in place at
    the cache's placement; the given cache object comes back. A
    recurrent family's state is new each step, as on the plain path
    (``api.decode_step``), and comes back at ``cache_shardings``."""
    cfg = run.model
    shard_fn = make_shard_fn(mesh)
    place = _state_placer(run, mesh)

    def decode_fn(params, cache, batch):
        with implicit_replication():
            logits, cache = api.decode_step(params, cache, batch, cfg,
                                            shard_fn)
            return logits, place(cache)

    return decode_fn


def serve_specs(run: RunConfig, shape, mesh):
    """(abstract params, abstract cache, inputs, and their shardings) of
    a prefill or decode cell, the reference's six-tuple: ``meta``
    tensors (no storage) and ``launch/sharding.Sharding`` trees. The
    cache length is the cell's seq_len (sliding-window archs cap at the
    window: the sub-quadratic property)."""
    cfg = run.model
    params = api.abstract(cfg)
    cache = api.cache_specs(cfg, shape.global_batch, shape.seq_len)
    inputs = api.input_specs(cfg, shape)
    pshard = param_shardings(mesh, api.specs(cfg), fsdp=True)
    cshard = cache_shardings(mesh, cache)
    ishard = batch_sharding(mesh, inputs)
    return params, cache, inputs, pshard, cshard, ishard
