"""Share of the profiled sub-window in which no operation ran on the
card (the union of the device trace's event intervals)."""
from portbench.readers import device_idle_pct as read  # noqa: F401
