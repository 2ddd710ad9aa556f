"""Parameter-spec system and nested-dict tree helpers.

Counterpart of ``repro/models/common.py``. Models declare parameters as
a nested dict of :class:`ParamSpec` (shape + logical axes + initializer);
``init_params`` materializes it with the reference's rule — ``normal``
leaves draw N(0, (0.02·scale)²), ``zeros``/``ones`` are constant — from
an explicit ``torch.Generator`` (no global RNG). Leaves are drawn in
sorted dotted-path order, so a seed fixes every leaf. The numbers differ
from JAX's init for the same seed; parity tests convert JAX params with
``models/convert.py`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.compat import torch_dtype

Tree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev = 0.02 * scale for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")
        if self.init not in ("normal", "zeros", "ones"):
            raise ValueError(f"unknown init {self.init!r}")


def stacked(spec: ParamSpec, layers: int) -> ParamSpec:
    """Add a leading ``layers`` dim (params stacked over layers)."""
    return ParamSpec((layers,) + spec.shape, ("layers",) + spec.axes,
                     spec.init, spec.scale)


def tree_paths(tree: Tree) -> list[tuple[str, Any]]:
    """Flatten a nested-dict tree into (dotted_path, leaf) pairs, keys
    sorted at every level (the order ``jax.tree.flatten`` gives dicts).
    Iterative: a recursive closure would be a reference cycle holding
    every leaf until the cyclic garbage collector ran (gigabytes of
    gradients at full width)."""
    out: list[tuple[str, Any]] = []
    stack = [("", tree)]
    while stack:
        prefix, node = stack.pop()
        if isinstance(node, dict):
            # pushed in reverse, so popped in sorted order, depth first
            for k in sorted(node, reverse=True):
                stack.append((f"{prefix}.{k}" if prefix else str(k),
                              node[k]))
        else:
            out.append((prefix, node))
    return out


def tree_from_paths(pairs) -> dict:
    """Inverse of :func:`tree_paths`."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def remat(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the backward
    instead of kept (``jax.checkpoint``'s counterpart): the train modes
    of the recurrent stacks wrap each layer or group in it. Memory
    changes, values do not."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kwargs)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of one or more same-shaped dict trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


DRAW_ELEMS = 1 << 31      # f32 elements drawn at once (8 GiB)


def init_params(gen: torch.Generator, specs: Tree, dtype: str,
                device: torch.device) -> Tree:
    """Materialize a ParamSpec tree on ``device``. Normal draws are made
    in f32 on the generator's device, then cast and moved, in runs of at
    most ``DRAW_ELEMS`` elements in storage order: a stacked expert leaf
    of a full-width moe model is tens of GB in f32. A leaf under the
    bound is one draw, so every dense and recurrent model's weights are
    those of one draw per leaf."""
    dt = torch_dtype(dtype)
    leaves = []
    for path, spec in tree_paths(specs):
        if spec.init == "zeros":
            x = torch.zeros(spec.shape, dtype=dt, device=device)
        elif spec.init == "ones":
            x = torch.ones(spec.shape, dtype=dt, device=device)
        else:
            x = torch.empty(spec.shape, dtype=dt, device=device)
            flat = x.view(-1)
            for lo in range(0, flat.numel(), DRAW_ELEMS):
                part = flat[lo:lo + DRAW_ELEMS]
                part.copy_(torch.randn(part.numel(), generator=gen,
                                       dtype=torch.float32,
                                       device=gen.device)
                           .mul_(0.02 * spec.scale))
        leaves.append((path, x))
    return tree_from_paths(leaves)
