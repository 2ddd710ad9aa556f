from repro_torch.data.pipeline import (BinarySource, DataConfig,
                                       SyntheticSource, batch_at,
                                       make_batches, make_source)

__all__ = ["BinarySource", "DataConfig", "SyntheticSource", "batch_at",
           "make_batches", "make_source"]
