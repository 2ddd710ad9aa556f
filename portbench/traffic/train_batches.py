"""Training batches: ``global_batch`` rows of ``seq_len`` tokens a step,
ids uniform over the vocabulary, drawn on the device from the seed and
the step, so the same seed gives the same batches and every row
differs; labels are the next tokens."""
from __future__ import annotations

import torch


def batch(mix: dict, seed: int, step: int, vocab: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + step) % (1 << 63))
    ids = torch.randint(0, vocab, (mix["global_batch"], mix["seq_len"] + 1),
                        generator=gen, device=device)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}
