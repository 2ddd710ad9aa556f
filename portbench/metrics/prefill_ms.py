"""Mean duration of the program's ``prefill`` and ``admission`` spans
(``serving/engine.py``): a prefill call and the wait for its logits."""
from portbench.readers import span_mean_ms


def read(rec):
    return span_mean_ms(rec, ("prefill", "admission"))
