"""Share of the profiled sub-window in which the card was idle while the
host was inside the ``experts`` span and no span within it
(``serving/dispatch.py``'s ``ep_experts``: the float32 casts and the
expert GEMMs; the exchanges' own spans take their idle time)."""
from portbench.idle import innermost_pct


def read(rec):
    return innermost_pct(rec, "experts")
