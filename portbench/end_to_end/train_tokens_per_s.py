"""Tokens trained over the window: steps x global batch x sequence, over
the window's time."""


def read(rec):
    mix = rec["mix"]
    return rec["steps"] * mix["global_batch"] * mix["seq_len"] \
        / (rec["t_end"] - rec["t0"])
