"""The flash-attention kernel's device time (``flash_fwd_*``) over the
device's busy time in the profiled sub-window."""
from portbench.readers import is_flash, kernel_share_pct


def read(rec):
    return kernel_share_pct(rec, is_flash)
