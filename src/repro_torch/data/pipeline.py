"""Tokenized LM data: deterministic, resumable, host-sharded.

Counterpart of ``repro/data/pipeline.py``, copied line for line (the
port imports nothing of ``repro``). It is numpy only, so the tokens for
(seed, step, index) are the reference's bit for bit:

* ``SyntheticSource`` — endless pseudo-text (zipfian draws with a
  deterministic bigram successor) generated statelessly from
  (seed, step, index).
* ``BinarySource`` — flat binary shards of token ids (uint16/uint32)
  read through memmap; sequences start at a stateless hash of
  (seed, step, index).

``batch_at`` gives the host-local {"tokens", "labels"} slice of the
global batch for one step, labels shifted by one token; ``make_batches``
yields them step after step.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import RunConfig


def _hash_u64(*ints: int) -> int:
    h = hashlib.blake2b(np.asarray(ints, np.int64).tobytes(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


class SyntheticSource:
    """Stateless synthetic token stream with a learnable structure
    (bigram-ish), so small-model training loss visibly decreases."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def sequence(self, step: int, index: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(_hash_u64(self.seed, step, index))
        v = self.vocab_size
        # zipfian unigram pool + deterministic "grammar": tok[t] depends on
        # tok[t-1] through a fixed affine map with occasional resets.
        pool = (rng.zipf(1.5, size=seq_len + 1) - 1) % v
        toks = np.empty(seq_len + 1, np.int64)
        toks[0] = pool[0]
        for t in range(1, seq_len + 1):
            if pool[t] % 7 == 0:      # reset: draw from pool
                toks[t] = pool[t]
            else:                      # deterministic bigram successor
                toks[t] = (toks[t - 1] * 31 + 17) % v
        return toks

    def num_sequences(self) -> Optional[int]:
        return None                    # endless


class BinarySource:
    """Flat binary token shards (``*.bin``), memmapped. dtype is read
    from a sidecar ``<name>.meta`` ("uint16"/"uint32"), default uint16."""

    def __init__(self, path: str, seed: int = 0):
        self.seed = seed
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".bin")) if os.path.isdir(path) else [path]
        if not files:
            raise FileNotFoundError(f"no .bin shards under {path!r}")
        self.maps = []
        for f in files:
            dtype = np.uint16
            meta = f[:-4] + ".meta"
            if os.path.exists(meta):
                with open(meta) as fh:
                    dtype = np.dtype(fh.read().strip())
            self.maps.append(np.memmap(f, dtype=dtype, mode="r"))
        self.sizes = np.array([m.shape[0] for m in self.maps], np.int64)
        self.total = int(self.sizes.sum())

    def sequence(self, step: int, index: int, seq_len: int) -> np.ndarray:
        start = _hash_u64(self.seed, step, index) % max(
            self.total - seq_len - 1, 1)
        cum = np.cumsum(self.sizes)
        shard = int(np.searchsorted(cum, start, side="right"))
        off = start - (cum[shard - 1] if shard else 0)
        m = self.maps[shard]
        need = seq_len + 1
        if off + need <= m.shape[0]:
            return np.asarray(m[off:off + need], np.int64)
        a = np.asarray(m[off:], np.int64)
        b = self.maps[(shard + 1) % len(self.maps)][: need - a.shape[0]]
        return np.concatenate([a, np.asarray(b, np.int64)])

    def num_sequences(self) -> Optional[int]:
        return None


@dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    host_index: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of the {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


def make_source(run: RunConfig):
    if run.data_path:
        return BinarySource(run.data_path, run.data_seed)
    return SyntheticSource(run.model.vocab_size, run.data_seed)


def batch_at(source, dc: DataConfig, step: int) -> dict:
    """The host-local batch for ``step`` — a pure function of (source
    config, step), so resuming at step k needs only k."""
    lo = dc.host_index * dc.host_batch
    seqs = np.stack([source.sequence(step, lo + i, dc.seq_len)
                     for i in range(dc.host_batch)])
    return {"tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32)}


def make_batches(source, dc: DataConfig, start_step: int = 0
                 ) -> Iterator[dict]:
    """``batch_at`` for ``start_step``, ``start_step + 1``, ... without
    end."""
    step = start_step
    while True:
        yield batch_at(source, dc, step)
        step += 1
