"""Share of the profiled sub-window in which the card was idle while the
host was inside the training step's ``backward`` span and no span within it
(``launch/steps.py``; split by exact overlap, ``portbench/idle.py``)."""
from portbench.idle import innermost_pct


def read(rec):
    return innermost_pct(rec, "backward")
