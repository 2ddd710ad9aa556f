"""The served run's share of the card's bf16 peak: the FLOPs of every
prompt and output token the run's requests were given
(``flops.request_flops``) over the time from the window's start to the
last of them."""
from portbench.readers import mfu_serve_pct as read  # noqa: F401
