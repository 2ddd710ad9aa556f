"""Mean duration of the program's ``decode`` span: the host's time to
issue one decode step (the span closes before the card finishes; the
wait is at the next flush boundary)."""
from portbench.readers import span_mean_ms


def read(rec):
    return span_mean_ms(rec, ("decode",))
