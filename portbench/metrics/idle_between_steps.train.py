"""Share of the profiled sub-window in which the card was idle while the
host was outside every ``step`` span (``launch/steps.py``): the
harness's read of the loss, its next batch and the step boundary."""
from portbench.idle import outside_pct


def read(rec):
    return outside_pct(rec, "step")
