"""Open-loop arrivals: independent users send on a schedule whatever
the system's backlog. ``rate_per_s`` times the window's seconds requests
(rounded down to a multiple of ``block``),
gaps at the quantiles of the exponential law (a Poisson process's gaps,
in an order the seed chooses); prompt lengths at the quantiles of a
log-uniform law and output lengths at those of a uniform law, in a
stratified order the seed chooses (``lengths.stratified_order``, strata
of ``block``); token ids uniform over the vocabulary, no shared prefix;
greedy decoding with no end token, so each request yields exactly its
output length."""
from __future__ import annotations

import numpy as np

from portbench.traffic.lengths import (exponential, log_uniform, rng_for,
                                       stratified_order, uniform_int)


def generate(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    b = mix["block"]
    n = max(1, int(mix["rate_per_s"] * seconds) // b) * b
    rng = rng_for(seed, 1)
    p, o = mix["prompt"], mix["output"]
    gaps = rng.permutation(exponential(n, mix["rate_per_s"]))
    plens = stratified_order(rng, log_uniform(n, p["min"], p["max"],
                                              p.get("step", 1)), b)
    outs = stratified_order(rng, uniform_int(n, o["min"], o["max"]), b)
    due = np.cumsum(gaps)
    ids = rng_for(seed, 2)
    return [{"uid": i, "due": float(due[i]),
             "prompt": ids.integers(0, vocab, int(plens[i]), dtype=np.int32),
             "max_new": int(outs[i])}
            for i in range(n) if due[i] < seconds]
