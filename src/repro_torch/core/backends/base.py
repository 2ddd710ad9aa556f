"""CommBackend — the pluggable transport behind serving (and, in a later
slice, gradient) collectives.

Counterpart of ``repro/core/backends/base.py``. Callers reach a strategy
only through the registry (``get_backend`` / ``available_modes``) and
never branch on mode names — the hadroNIO transparency boundary. This
slice ports the serving wire path (``serve_emit``) and the registry; the
gradient exchange, state layouts and the staged slice pipeline come with
the training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import CommConfig

SERVE_KINDS = ("all_reduce", "all_gather")


@dataclass(frozen=True)
class SyncContext:
    """Resolved ring topology for one emission. ``world_size`` is the
    ring size and ``rank`` this peer's place in it; ``channel_indices``
    is the owning event loop's disjoint run of the channel pool (None =
    the whole ``comm.channels`` pool)."""
    comm: CommConfig
    world_size: int = 1
    rank: int = 0
    channel_indices: Optional[tuple] = None


class CommBackend(abc.ABC):
    """One synchronization strategy. Subclass + ``@register("name")``."""

    name: str = ""            # set by @register

    @abc.abstractmethod
    def serve_emit(self, flat: torch.Tensor, ctx: SyncContext,
                   kind: str) -> torch.Tensor:
        """Emit ONE flat f32 serving payload (a tensor-parallel partial
        logit sum, or the coalesced prefill gathering write) through this
        strategy's wire. ``kind`` is one of ``SERVE_KINDS``: all_reduce
        (sum over the ring) or all_gather (peer-major concatenation)."""


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
