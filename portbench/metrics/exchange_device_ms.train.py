"""Device milliseconds a step spends in the exchange's kernels: the
hand-written pack and unpack (``pack_kernel``, ``unpack_kernel``) and
NCCL's, over the profiled steps."""
from portbench.readers import is_exchange, per_step_ms


def read(rec):
    return per_step_ms(rec, is_exchange)
