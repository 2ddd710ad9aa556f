"""Offline batch generation: a backlog larger than a window can finish,
queued at the window's start. Prompt lengths at the quantiles of a
log-uniform law and output lengths at those of a uniform law, in a
stratified order the seed chooses (``lengths.stratified_order``: every
``block`` consecutive requests span the law), so whatever prefix of the
backlog a window completes has the mix's sizes. Token ids uniform over
the vocabulary, no shared prefix; greedy decoding with no end token."""
from __future__ import annotations

from portbench.traffic.lengths import (log_uniform, rng_for,
                                       stratified_order, uniform_int)


def generate(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    b = mix["block"]
    n = -(-mix["backlog"] // b) * b
    rng = rng_for(seed, 1)
    p, o = mix["prompt"], mix["output"]
    plens = stratified_order(rng, log_uniform(n, p["min"], p["max"],
                                              p.get("step", 1)), b)
    outs = stratified_order(rng, uniform_int(n, o["min"], o["max"]), b)
    ids = rng_for(seed, 2)
    return [{"uid": i, "due": 0.0,
             "prompt": ids.integers(0, vocab, int(plens[i]), dtype="int32"),
             "max_new": int(outs[i])}
            for i in range(n)]
