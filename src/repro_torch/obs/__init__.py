"""The port's telemetry plane (counterpart of ``repro/obs``). Only
:class:`~repro_torch.obs.metrics.RingLog` is ported so far; the
registry, the span tracer and the baseline gate are ROADMAP.md Queue 1
item 6.5."""
from repro_torch.obs.metrics import RingLog

__all__ = ["RingLog"]
