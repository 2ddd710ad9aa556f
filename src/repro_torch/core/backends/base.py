"""CommBackend — the pluggable transport behind gradient and serving
collectives.

Counterpart of ``repro/core/backends/base.py``. hadroNIO keeps the NIO
API while the transport underneath is swapped; here every
synchronization strategy is a :class:`CommBackend` registered by mode
name, and callers reach one only through the registry
(``get_backend`` / ``available_modes``) — ``core/tac.py`` and
``launch/steps.py`` carry no per-mode branches. A backend owns:

* ``sync(grads, ctx) -> SyncResult`` — the collective schedule of one
  gradient exchange;
* ``state_specs(run, n_shards, pod_size)`` — the optimizer and
  error-feedback state layout it needs (tree moments, or ZeRO-1 flat
  shards, in-pod when the ring has pods);
* ``apply_update(...)`` — how synced gradients become a parameter
  update (tree AdamW by default; the ZeRO-1 shard update and its gather
  epilogue for the reduce-scatter strategies);
* ``serve_emit`` — the serving wire;
* ``gathered_grads`` / ``reshard_flat_shards`` — the synced tree back
  from a ZeRO-1 shard, and the flat state re-sliced for another ring.

Capability flags replace mode names: ``manual`` (the backend exchanges
gradients itself, in the TAC step) and ``zero1`` (its optimizer moments
are flat ring-sharded slices).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import CommConfig, RunConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.channels import Ring
from repro_torch.models import api
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw

Tree = Any
# an error-feedback residual: one tensor keyed to the ring plan, or a
# tuple of tensors keyed by bucket id (the overlap modes)
EF = Union[torch.Tensor, tuple, None]

SERVE_KINDS = ("all_reduce", "all_gather", "all_to_all")


class SyncResult(NamedTuple):
    """What one gradient exchange produced (the same for every
    backend — the other half of the transparency boundary)."""
    grads: Tree               # synced grads (tree), or None in zero1 modes
    flat_shard: Optional[torch.Tensor] = None   # this peer's ZeRO-1 shard
    plan: Any = None          # backend-owned pack plan (ring or bucketed)
    ef: EF = None             # new error-feedback residual (this peer's)
    gather_group: Any = None  # process group the zero1 shard was
    #                           scattered over (the ring's group)


@dataclass(frozen=True)
class SyncContext:
    """Resolved ring topology and carried state for one emission.
    ``world_size`` is the ring size and ``rank`` this peer's place in
    it; ``channel_indices`` is the owning event loop's disjoint run of
    the channel pool (None = the whole ``comm.channels`` pool); ``ring``
    holds the process group and channel communicators of the exchange;
    ``ef`` is this peer's error-feedback residual.

    The context is pod-aware (:attr:`pod_axis`) exactly when the ring
    has a pod axis and ``comm.hierarchical`` is on, as the reference's
    ``SyncContext.resolve``: with it off, (pod, data) is one flat
    ring."""
    comm: CommConfig
    world_size: int = 1
    rank: int = 0
    channel_indices: Optional[tuple] = None
    ring: Optional[Ring] = None
    ef: EF = None

    @property
    def pod_axis(self) -> Optional[str]:
        """The ring's pod axis when pod-aware collectives apply, else
        None."""
        if self.ring is None or not self.comm.hierarchical:
            return None
        return self.ring.pod_axis


class StateSpecs(NamedTuple):
    """Backend-owned part of the train state, as ``meta`` tensors (shape
    and dtype, no storage)."""
    opt: adamw.AdamState      # moment layout (tree, or this peer's flat
    #                           ZeRO-1 shard)
    ef: EF                    # this peer's error-feedback layout: one
    #                           tensor, or a tuple keyed by bucket id


@dataclass(frozen=True)
class UpdateContext:
    """Ring facts ``apply_update`` needs beyond the sync result (the
    ring size is ``ring.world_size``; ``eff_shards`` is the ZeRO-1
    scatter-group size; ``donate``: the step's caller gave its state up,
    so the update may write into the params and moments it was given).
    ``memo`` keeps what :meth:`cached` built for the life of the step
    function that owns this context."""
    ring: Ring
    eff_shards: int = 1
    donate: bool = False

    @property
    def shard_index(self) -> int:
        """This peer's index in its ZeRO-1 scatter group: the in-pod
        index when the group is in-pod (pod-major ranks), the ring rank
        when it is the whole ring."""
        return self.ring.rank % self.eff_shards
    memo: dict = field(default_factory=dict, compare=False, repr=False)

    def cached(self, key, build: Callable[[], Any]):
        """``build()``, made once per ``key``: a ZeRO-1 decay-mask shard
        is ~2 GB at full width and the same every step."""
        if key not in self.memo:
            self.memo[key] = build()
        return self.memo[key]


def scatter_group_size(n_shards: int, pod_size: int,
                       comm: CommConfig) -> int:
    """ZeRO-1 scatter-group size, the reference's rule: with
    hierarchical (pod-aware) collectives the reduce-scatter runs IN-POD,
    so shards are ``1/in-pod`` of a slice and replicate across pods
    (hierarchical ZeRO); otherwise the whole flat ring. ``pod_size`` is
    the size of the pod axis (the number of pods), as in the reference's
    ``mesh.shape["pod"]``."""
    if comm.hierarchical and pod_size > 1:
        if n_shards % pod_size:
            raise ValueError(f"{pod_size} pods do not divide a ring of "
                             f"{n_shards} peers")
        return n_shards // pod_size
    return n_shards


class CommBackend(abc.ABC):
    """One synchronization strategy. Subclass + ``@register("name")``."""

    name: str = ""            # set by @register
    manual: bool = True       # True: exchanges gradients in the TAC step
    zero1: bool = False       # True: flat ring-sharded optimizer moments

    @abc.abstractmethod
    def sync(self, grads: Tree, ctx: SyncContext) -> SyncResult:
        """Exchange this peer's gradients over the ring."""

    def needs_ef(self, comm: CommConfig) -> bool:
        return comm.compress in ("bf16", "int8_ef")

    def state_specs(self, run: RunConfig, n_shards: int = 1,
                    pod_size: int = 1) -> StateSpecs:
        """Default layout: f32 tree moments shaped like the params, and
        this peer's (n_slices, slice_elems) f32 error-feedback residual
        when compression is on, whatever the ring. (The reference's
        global state carries a leading ring dim of ``n_shards``; each
        process here holds its own row.)"""
        specs = api.specs(run.model)
        meta = lambda shape: torch.empty(shape, dtype=torch.float32,
                                         device="meta")
        moments = lambda: tree_map(lambda s: meta(s.shape), specs)
        ef = None
        if self.needs_ef(run.comm):
            plan = agg.make_plan(specs, run.comm)
            ef = meta((plan.n_slices, plan.slice_elems))
        return StateSpecs(opt=adamw.AdamState(mu=moments(), nu=moments(),
                                              count=0), ef=ef)

    def apply_update(self, params: Tree, opt: adamw.AdamState,
                     res: SyncResult, run: RunConfig, uctx: UpdateContext):
        """(new_params, new_opt, metrics) from a SyncResult. Default: tree
        AdamW on the synced gradient tree, in place under
        ``uctx.donate``. ``metrics`` holds scalars that are equal on
        every ring peer (``grad_norm``, ``lr``)."""
        return adamw.update(res.grads, opt, params, run,
                            inplace=uctx.donate)

    def validate(self, comm: CommConfig) -> None:
        """Reject config combinations this strategy cannot honor (called
        when the step is built)."""

    def serve_emit(self, flat: torch.Tensor, ctx: SyncContext,
                   kind: str) -> torch.Tensor:
        """Emit ONE flat f32 serving payload (a tensor-parallel partial
        logit sum, or the coalesced prefill gathering write) through this
        strategy's wire — the inference side of the transparency
        boundary: ``serving/dispatch.py`` never branches on mode names.
        ``kind`` is one of ``SERVE_KINDS``: all_reduce (sum over the
        ring), all_gather (peer-major concatenation, ring size times
        the payload) or all_to_all (the moe expert exchange: the payload
        is a peer-major ``(ring, len // ring)`` block and each peer
        receives its row of every peer's block, in the same layout).
        Default: the sliced emission the hadronio family
        shares (``pipeline.emit_flat``: ring-buffer slices through the
        channel schedule at the configured aggregate/flush, on the
        context's ``channel_indices``). Every strategy returns the same
        values; only the emission differs."""
        from repro_torch.core.backends import pipeline
        return pipeline.emit_flat(flat, ctx, kind)

    def gathered_grads(self, res: SyncResult, like: Tree) -> Tree:
        """The full synced-gradient tree of a SyncResult. Default: the
        tree is already there. ZeRO-1 backends override: all-gather their
        flat shard over ``res.gather_group`` and unpack. Tests and tools
        read it; the train step never needs it."""
        if res.grads is None:
            raise TypeError(f"{self.name}: a zero1 backend must override "
                            "gathered_grads")
        return res.grads

    def reshard_flat_shards(self, run: RunConfig, stacked, new_shards: int):
        """Re-slice checkpointed ring-sharded flat optimizer state (global
        ``(old_shards, len)`` numpy array) for a ring of ``new_shards``
        (elastic restore). Only zero1 backends have such state; its
        layout is theirs, so the rule is too."""
        raise ValueError(
            f"comm backend {self.name!r} has no ring-sharded flat state "
            "to reshard")


_REGISTRY: dict[str, CommBackend] = {}


def register(name: str):
    """Class decorator: instantiates the backend as a stateless
    singleton under ``name``."""
    def deco(cls):
        cls.name = name
        if name in _REGISTRY:
            raise ValueError(f"comm backend {name!r} already registered")
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_backend(name: str) -> CommBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown comm mode {name!r}; registered: "
                       f"{', '.join(available_modes())}") from None


def available_modes() -> tuple:
    """Every registered mode name, sorted (config validation and CLI
    choices read this)."""
    return tuple(sorted(_REGISTRY))
