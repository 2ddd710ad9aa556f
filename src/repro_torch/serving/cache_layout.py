"""Per-family decode-state layouts: where each cache leaf carries its
batch axis.

Counterpart of ``repro/serving/cache_layout.py``. The prefill gathering
write in ``serving/dispatch.py`` coalesces every cache leaf plus the
last-token logits into one flat payload and carves it back with the
batch rows re-merged peer-major; the one family-specific fact it needs
is each leaf's batch axis, declared here. Only the dense family is
ported: its KV pages ``{"k","v"}: (L, B, S, KV, Dh)`` carry batch at
axis 1. The other families' layouts come with them (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

from repro_torch.models.common import tree_paths

# resolver: (path_keys, leaf) -> batch axis of that cache leaf
LayoutFn = Callable[[Tuple[str, ...], Any], int]


def _stacked_axis1(path: Tuple[str, ...], leaf: Any) -> int:
    """Layer-stacked KV pages (L, B, S, KV, Dh): batch at axis 1."""
    return 1


CACHE_LAYOUTS: dict[str, LayoutFn] = {
    "dense": _stacked_axis1,
}


def layout_for(family: str) -> LayoutFn:
    try:
        return CACHE_LAYOUTS[family]
    except KeyError:
        raise NotImplementedError(
            f"family {family!r} declares no cache layout in repro_torch yet "
            "(ROADMAP.md, Queue 1: 'The other model families')") from None


def batch_axes(family: str, cache: dict) -> list:
    """Per-leaf batch axes of ``cache`` in ``tree_paths`` (sorted-key)
    order — the order the dispatch merge loop consumes."""
    fn = layout_for(family)
    axes = []
    for path, leaf in tree_paths(cache):
        ba = fn(tuple(path.split(".")), leaf)
        if not 0 <= ba < leaf.dim():
            raise ValueError(f"{family}: batch axis {ba} out of range for "
                             f"{path} {tuple(leaf.shape)}")
        axes.append(ba)
    return axes
