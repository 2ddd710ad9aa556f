from repro_torch.models import api
from repro_torch.models.api import (decode_step, grow_cache, init,
                                    init_cache, loss, prefill, specs)

__all__ = ["api", "decode_step", "grow_cache", "init", "init_cache", "loss",
           "prefill", "specs"]
