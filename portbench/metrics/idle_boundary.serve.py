"""Share of the profiled sub-window in which the card was idle while the
host was inside the engine's ``boundary`` span and no span within it
(``serving/engine.py``: the wait at a decode-step boundary, the token
read-back, the slot bookkeeping, the admission hook and gate)."""
from portbench.idle import innermost_pct


def read(rec):
    return innermost_pct(rec, "boundary")
