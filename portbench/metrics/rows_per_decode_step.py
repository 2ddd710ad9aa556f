"""Rows a decode step carried: the tokens the decode steps produced
over the engine's ``decode_steps`` counter (continuous batching's
occupancy of the slots)."""
from portbench.readers import rows_per_decode_step as read  # noqa: F401
