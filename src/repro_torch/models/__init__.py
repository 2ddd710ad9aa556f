from repro_torch.models import api
from repro_torch.models.api import (abstract, cache_specs, decode_step,
                                    grow_cache, init, init_cache,
                                    input_specs, loss, prefill, specs)

__all__ = ["api", "abstract", "cache_specs", "decode_step", "grow_cache",
           "init", "init_cache", "input_specs", "loss", "prefill", "specs"]
