"""The prefills' share of the card's bf16 peak: the FLOPs the prompts
prefilled in the run need (``flops.prefill_flops``, each prompt at its
own length, not its padded one) over the summed duration of the
program's ``prefill`` and ``admission`` spans."""
from portbench.readers import mfu_prefill_pct as read  # noqa: F401
