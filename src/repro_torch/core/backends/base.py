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
* ``state_specs(run)`` — the optimizer and error-feedback state layout
  it needs;
* ``apply_update(...)`` — how synced gradients become a parameter
  update (tree AdamW by default);
* ``serve_emit`` — the serving wire.

A capability flag replaces mode names: ``manual`` (the backend
exchanges gradients itself, in the TAC step). The reference's ``zero1``
flag and ``SyncResult.flat_shard`` come with the ZeRO-1 modes
(ROADMAP.md Queue 1 item 4).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import CommConfig, RunConfig
from repro_torch.core import aggregation as agg
from repro_torch.core.channels import Ring
from repro_torch.models import api
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw

Tree = Any

SERVE_KINDS = ("all_reduce", "all_gather")


class SyncResult(NamedTuple):
    """What one gradient exchange produced (the same for every
    backend — the other half of the transparency boundary)."""
    grads: Tree               # synced grads (tree)
    plan: Any = None          # backend-owned pack plan
    ef: Optional[torch.Tensor] = None    # new error-feedback residual
    #                                      (this peer's, keyed to the plan)


@dataclass(frozen=True)
class SyncContext:
    """Resolved ring topology and carried state for one emission.
    ``world_size`` is the ring size and ``rank`` this peer's place in
    it; ``channel_indices`` is the owning event loop's disjoint run of
    the channel pool (None = the whole ``comm.channels`` pool); ``ring``
    holds the process group and channel communicators of a gradient
    exchange; ``ef`` is this peer's error-feedback residual."""
    comm: CommConfig
    world_size: int = 1
    rank: int = 0
    channel_indices: Optional[tuple] = None
    ring: Optional[Ring] = None
    ef: Optional[torch.Tensor] = None


class StateSpecs(NamedTuple):
    """Backend-owned part of the train state, as ``meta`` tensors (shape
    and dtype, no storage)."""
    opt: adamw.AdamState      # moment layout
    ef: Optional[torch.Tensor]   # this peer's error-feedback layout


@dataclass(frozen=True)
class UpdateContext:
    """Ring facts ``apply_update`` needs beyond the sync result (the
    ring size is ``ring.world_size``)."""
    ring: Ring


class CommBackend(abc.ABC):
    """One synchronization strategy. Subclass + ``@register("name")``."""

    name: str = ""            # set by @register
    manual: bool = True       # True: exchanges gradients in the TAC step

    @abc.abstractmethod
    def sync(self, grads: Tree, ctx: SyncContext) -> SyncResult:
        """Exchange this peer's gradients over the ring."""

    def needs_ef(self, comm: CommConfig) -> bool:
        return comm.compress in ("bf16", "int8_ef")

    def state_specs(self, run: RunConfig) -> StateSpecs:
        """Default layout: f32 tree moments shaped like the params, and
        this peer's (n_slices, slice_elems) f32 error-feedback residual
        when compression is on. (The reference's global EF carries a
        leading ring dim; each process here holds its own row.)"""
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
        AdamW on the synced gradient tree. ``metrics`` holds scalars that
        are equal on every ring peer (``grad_norm``, ``lr``)."""
        return adamw.update(res.grads, opt, params, run)

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
        ring) or all_gather (peer-major concatenation, ring size times
        the payload). Default: the sliced emission the hadronio family
        shares (``pipeline.emit_flat``: ring-buffer slices through the
        channel schedule at the configured aggregate/flush, on the
        context's ``channel_indices``). Every strategy returns the same
        values; only the emission differs."""
        from repro_torch.core.backends import pipeline
        group = ctx.world_size if kind == "all_gather" else 1
        return pipeline.emit_flat(flat, ctx, kind, group=group)


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
