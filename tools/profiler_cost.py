#!/usr/bin/env python3
"""Time the profiler's post-processing with and without the host's op
events, and read raw, on one card.

  python3 tools/profiler_cost.py

Profiles the loss and gradients of two full-width train steps (rwkv6-7b
at 1 of 32 layers, B=2, S=512; qwen2-0.5b whole, B=4, S=1024; random
weights from seed 0, chip_smoke.py's batches) twice each in turns: with
``ProfilerActivity.CPU`` and ``CUDA`` listed by ``prof.events()``, with
``CUDA`` alone listed the same way, and with ``CUDA`` alone read off the
raw results (chip_smoke.py's ``device_events``). Prints per trace the
kernels recorded, their summed device ms, the seconds of the profiled
call and the seconds the listing takes. chip_smoke.py's
``profile_device`` traces the card alone and reads it raw on these
numbers. Needs a card.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402

CASES = (("rwkv6-7b", 1, 2, 512), ("qwen2-0.5b", 24, 4, 1024))


def traced(fn, activities, raw: bool):
    """(kernels, summed kernel ms, profiled call s, post-processing s,
    {name: ms}) of one ``fn`` call after an unprofiled one; ``raw``: the
    events read by ``chip_smoke.device_events``."""
    from torch.profiler import profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if raw:
        events = cs.device_events(prof)
    else:
        events = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms
    return len(events), sum(by_name.values()), t1 - t0, \
        time.perf_counter() - t1, by_name


def main() -> int:
    from torch.profiler import ProfilerActivity
    if not torch.cuda.is_available():
        print("profiler_cost: CUDA is not available", file=sys.stderr)
        return 1
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    card = [ProfilerActivity.CUDA]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch, layers, b, s in CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        params = api.init(gen, cfg, device="cuda")
        batch = cs.family_batch(cfg, b, s, 0, "cuda")
        ways = ((both, False, "cpu+cuda"), (card, False, "cuda"),
                (card, True, "cuda raw"))
        for acts, raw, name in ways + ways:
            n, ms, run_s, post_s, by_name = traced(
                lambda: cs.loss_and_grads(params, batch, cfg), acts, raw)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:2]
            print(f"{arch} ({layers} layers, B={b} S={s}) {name}: {n} "
                  f"kernels {ms:.3f} ms; profiled call {run_s:.2f} s, "
                  f"post-processing {post_s:.2f} s; top "
                  f"{[(k[:40], round(v, 3)) for k, v in top]}", flush=True)
        del params, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
