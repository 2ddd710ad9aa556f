from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamState

__all__ = ["adamw", "AdamState"]
