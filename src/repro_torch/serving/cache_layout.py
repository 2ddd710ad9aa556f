"""Per-family decode-state layouts: where each cache leaf carries its
batch axis.

Counterpart of ``repro/serving/cache_layout.py``. The prefill gathering
write in ``serving/dispatch.py`` coalesces every cache leaf plus the
last-token logits into one flat payload and carves it back with the
batch rows re-merged peer-major; the one family-specific fact it needs
is each leaf's batch axis, declared here:

============  ==============================================  =========
family        cache leaves                                    batch axis
============  ==============================================  =========
dense         KV pages ``{"k","v"}: (L, B, S, KV, Dh)``       1
moe           the same KV pages as dense (the expert          1
              stage keeps no state across steps)
ssm           rwkv6 state ``wkv (L, B, H, hs, hs)``,          1
              ``tm_x`` / ``cm_x (L, B, 1, D)``
hybrid        MIXED: the ``groups`` subtree stacks each       1
              pattern entry ``(n_groups, B, ...)``; the
              unstacked ``tail*`` entries lead with batch     0
              ``(B, ...)``
encdec        whisper ``self`` KV ``(L, B, S, KV, Dh)`` plus  1
              ``cross_k`` / ``cross_v (L, B, frames, ...)``
vlm           llava KV pages with the vision prefix folded    1
              into the leading slots ``(L, B, P + S, ...)``
============  ==============================================  =========
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

from repro_torch.models.common import tree_paths

# resolver: (path_keys, leaf) -> batch axis of that cache leaf
LayoutFn = Callable[[Tuple[str, ...], Any], int]


def _stacked_axis1(path: Tuple[str, ...], leaf: Any) -> int:
    """Layer-stacked state (KV pages, cross K/V, rwkv6 state): batch at
    axis 1."""
    return 1


def _hybrid_mixed(path: Tuple[str, ...], leaf: Any) -> int:
    """recurrentgemma: batch at axis 1 under ``groups`` (stacked over the
    groups), axis 0 in the unstacked ``tail*`` entries."""
    return 1 if "groups" in path else 0


CACHE_LAYOUTS: dict[str, LayoutFn] = {
    "dense": _stacked_axis1,
    "moe": _stacked_axis1,
    "ssm": _stacked_axis1,
    "hybrid": _hybrid_mixed,
    "encdec": _stacked_axis1,
    "vlm": _stacked_axis1,
}


def layout_for(family: str) -> LayoutFn:
    """The family's resolver; a family without one fails when its serve
    step is built, not when a gathered cache is carved wrongly."""
    try:
        return CACHE_LAYOUTS[family]
    except KeyError:
        raise ValueError(
            f"family {family!r} declares no cache layout: register its "
            "batch axes in repro_torch.serving.cache_layout.CACHE_LAYOUTS"
        ) from None


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
