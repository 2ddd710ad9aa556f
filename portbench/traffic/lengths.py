"""Shared arithmetic of the traffic generators: the same multiset of
sizes for every seed, drawn as evenly spaced quantiles of the mix's
distribution and put in an order that the seed chooses, stratified so
that every few consecutive requests span the distribution. A seed then
changes which request gets which size and when, never how much work a
run offers."""
from __future__ import annotations

import math

import numpy as np


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def log_uniform(n: int, lo: int, hi: int, step: int = 1) -> np.ndarray:
    """``n`` lengths at the quantiles of a log-uniform law on [lo, hi],
    rounded down to a multiple of ``step`` (lo and hi are multiples)."""
    x = np.exp(math.log(lo) + quantiles(n) * (math.log(hi) - math.log(lo)))
    return np.clip((x // step) * step, lo, hi).astype(np.int64)


def uniform_int(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` integers at the quantiles of the uniform law on lo..hi."""
    return (lo + np.floor(quantiles(n) * (hi - lo + 1))).astype(np.int64)


def exponential(n: int, rate: float) -> np.ndarray:
    """``n`` gaps at the quantiles of the exponential law of ``rate``."""
    return -np.log1p(-quantiles(n)) / rate


def stratified_order(rng: np.random.Generator, values: np.ndarray,
                     block: int) -> np.ndarray:
    """``values`` (sorted, a multiple of ``block`` of them) in an order
    the seed draws, such that every run of ``block`` consecutive requests
    holds one value of each of ``block`` equal strata (the lowest values,
    the next, ...): whatever stretch of the sequence a window takes has
    the law's spread of sizes."""
    strata = np.sort(values).reshape(block, -1)
    cols = np.stack([rng.permutation(row) for row in strata], axis=1)
    return np.concatenate([rng.permutation(c) for c in cols])


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), purpose])
