"""TAC — the paper's primary contribution: the transparent gradient
exchange (``tac.sync_grads``) and the layers under it. Counterpart of
``repro/core/__init__.py``, with its exports."""
from repro_torch.core import aggregation, channels, compress, hierarchical, \
    ring_buffer, selector, tac
from repro_torch.core.aggregation import PackPlan, as_slices, from_slices, \
    make_plan, pack, unpack
from repro_torch.core.ring_buffer import SlicePlan, plan_slices
from repro_torch.core.tac import SyncResult, gather_updated, sync_grads

__all__ = [
    "PackPlan", "SlicePlan", "SyncResult", "aggregation", "as_slices",
    "channels", "compress", "from_slices", "gather_updated", "hierarchical",
    "make_plan", "pack", "plan_slices", "ring_buffer", "selector",
    "sync_grads", "tac", "unpack",
]
