"""Process start to the window's start: loading, building the kernels,
the ring's communicators, the weights and the warm-up."""


def read(rec):
    return rec["setup_s"]
