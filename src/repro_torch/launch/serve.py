"""Serving launcher of the port: load params from a train checkpoint
(``--ckpt``) or init them from a seed, run the event-loop serving
subsystem (EventLoopGroup of decode engines over the CommBackend wire
and a ring of peers), print the reference CLI's summary lines.

Counterpart of ``repro/launch/serve.py`` in its single-tenant,
unsupervised form (tenants, the supervisor, pods and the telemetry
flags come in later slices: ROADMAP.md). Runs on the card unless
``--device cpu`` is given.

The ring is one process per peer. The CLI joins an existing
``torch.distributed`` default group; without one it makes one: from the
environment (``env://``) when ``WORLD_SIZE`` is set, as ``torchrun``
sets it, else a group of one peer in-process (NCCL on the card, gloo on
the CPU, a ``HashStore`` so that no port is opened), which it destroys
at the end. Every peer serves the same requests; only rank 0 prints.
Over a ring of more than one peer the event loops are drained inline,
one after another: every peer must issue each loop's collectives in the
same order, and threads sharing the ring's group would interleave them
differently on each peer.

CLI::

  python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8 \
      --batch 2 --max-len 2048 --event-loops 2 --poll busy \
      --comm-mode hadronio --aggregate channel --flush ready

  # a ring of 2 peers on the CPU (gloo)
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen2-0.5b-reduced --device cpu --comm-mode hadronio \
      --requests 6 --max-new 4 --batch 2

  # params from a train checkpoint: the LATEST step of a directory that
  # launch.train (or the reference's trainer) wrote, f32 or bf16
  python -m repro_torch.launch.train --arch mixtral-8x7b-reduced \
      --device cpu --steps 3 --global-batch 4 --seq-len 32 --ckpt /tmp/run1
  python -m repro_torch.launch.serve --arch mixtral-8x7b-reduced \
      --device cpu --ckpt /tmp/run1

  # CPU-sized smoke runs (any registry id, with -reduced)
  python -m repro_torch.launch.serve --arch qwen2-0.5b-reduced \
      --device cpu --requests 6 --max-new 4
  python -m repro_torch.launch.serve --arch rwkv6-7b-reduced \
      --device cpu --requests 4 --max-new 4 --batch 2
  python -m repro_torch.launch.serve --arch recurrentgemma-9b-reduced \
      --device cpu --requests 4 --max-new 4 --batch 2
  # moe: the expert stage through the all_to_all wire (any mode but the
  # one-peer gspmd path, which runs it locally)
  python -m repro_torch.launch.serve --arch mixtral-8x7b-reduced \
      --device cpu --comm-mode hadronio
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch mixtral-8x7b-reduced --device cpu --comm-mode hadronio \
      --requests 6 --max-new 4 --batch 2
  # encdec (zero frame embeddings) and vlm (a zero patch prefix); on
  # the card at full width: --arch whisper-tiny, llava-next-mistral-7b
  python -m repro_torch.launch.serve --arch whisper-tiny-reduced \
      --device cpu --requests 6 --max-new 4 --batch 2
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b-reduced \
      --device cpu --requests 6 --max-new 4 --batch 2

The recurrent families (rwkv6, recurrentgemma) serve equal-length
buckets of prompts, so requests of distinct lengths run one per wave.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointStore
from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.configs.base import (CommConfig, RunConfig, ServeConfig,
                                      ShapeConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.backends import available_modes
from repro_torch.core.channels import Ring
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.serving import Request, make_engine_group


def make_requests(cfg, n: int, *, max_new: int, temperature: float,
                  seed: int, min_len: int = 4, max_len: int = 32) -> list:
    """``n`` requests with prompt lengths drawn in ``[min_len, max_len)``
    and tokens drawn from the vocabulary, all from ``seed``."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(min_len, max_len)),
                    max_new=max_new, temperature=temperature)
            for i in range(n)]


def load_params(cfg, *, ckpt: str, batch: int, max_len: int, seed: int,
                device: DeviceLike = None,
                log: Callable[[str], None] = print):
    """The params of ``ckpt``'s LATEST train checkpoint on ``device``,
    else (no ``ckpt``, or no LATEST in it) params from ``seed``, as the
    reference's ``load_params``. The restore's ``like`` tree is the
    reference's: the train state of a ``"decode"`` shape of ``max_len``
    x ``batch`` under the default comm config. Only its params and step
    are read (serving needs nothing else, and so a checkpoint of any
    comm mode serves); a leaf that is missing or of another shape
    raises. ``log`` gets the restore line."""
    dev = resolve_device(device)
    store = CheckpointStore(ckpt) if ckpt else None
    step = store.latest_step() if store else None
    if step is None:
        return api.init(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", "decode", max_len,
                                                 batch))
    like = steps.abstract_state(run)._replace(opt=None, ef=None)
    state = store.restore(step, like, device=dev)
    log(f"[serve] restored params from step {step}")
    return state.params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True,
                   help=f"registry id: {', '.join(ARCH_IDS)}, each also "
                        "with -reduced (the CPU-sized variant); the "
                        "encdec and vlm frontends are stubs fed zeros")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--ckpt", default="",
                   help="train checkpoint directory: serve the params of "
                        "its LATEST step (without one, init from --seed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--event-loops", type=int, default=1,
                   help="EventLoopGroup size; each loop owns a disjoint "
                        "run of the channel pool. The loops run in threads "
                        "on a ring of one peer and inline, one after "
                        "another, on a ring of more (every peer must issue "
                        "the collectives in the same order)")
    p.add_argument("--poll", default="busy", choices=ServeConfig.POLLS,
                   help="completion polling: busy spins, park blocks, "
                        "adaptive spins then parks (hadroNIO §IV-B)")
    p.add_argument("--comm-mode", default="gspmd", choices=available_modes(),
                   help="CommBackend the serving collectives (KV gathers, "
                        "TP logit reductions) flow through; the overlap "
                        "modes always flush when ready, and the ZeRO-1 "
                        "modes (whose training shards the optimizer "
                        "moments over the ring) serve through the sliced "
                        "hadronio wire")
    p.add_argument("--channels", type=int, default=4,
                   help="global CommChannel pool partitioned across loops")
    p.add_argument("--aggregate", default="slice",
                   choices=CommConfig.AGGREGATES,
                   help="wire flush granularity of the sliced modes: one "
                        "collective per slice, or one per channel")
    p.add_argument("--flush", default="step", choices=CommConfig.FLUSHES,
                   help="channel schedule: flush at the end of the "
                        "emission, or each channel when it fills")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) raises when no card is present")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    serve = ServeConfig(event_loops=args.event_loops, poll=args.poll,
                        max_batch=args.batch, max_len=args.max_len,
                        comm=CommConfig(mode=args.comm_mode,
                                        channels=args.channels,
                                        aggregate=args.aggregate,
                                        flush=args.flush))
    own_group = not dist.is_initialized()
    if own_group:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            if device.type == "cuda":     # one card per peer of the host
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    try:
        ring = Ring(channels=args.channels)
        params = load_params(cfg, ckpt=args.ckpt, batch=args.batch,
                             max_len=args.max_len, seed=args.seed,
                             device=device, log=print if ring.rank == 0
                             else lambda line: None)
        group = make_engine_group(cfg, params, serve, seed=args.seed,
                                  device=device, ring=ring)
        reqs = make_requests(cfg, args.requests, max_new=args.max_new,
                             temperature=args.temperature, seed=args.seed)
        t0 = time.time()
        group.submit(reqs)
        threads = args.event_loops > 1 and ring.world_size == 1
        results = sorted(group.run(threads=threads), key=lambda r: r.uid)
        dt = time.time() - t0
    finally:
        if own_group:
            dist.destroy_process_group()
    if ring.rank != 0:
        return 0
    tok = sum(len(r.tokens) for r in results)
    st = group.poll_stats()
    print(f"[serve] {len(results)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s) | {serve.event_loops} event loop(s), "
          f"poll={serve.poll} (spins={st.spins} parks={st.parks}), "
          f"comm={args.comm_mode}, ring={ring.world_size}, device={device}")
    for loop in group.loops:
        print(f"  loop {loop.index}: channels={loop.channels} "
              f"results={len(loop.results)}")
    for r in results[:4]:
        print(f"  uid={r.uid} prompt_len={r.prompt_len} -> "
              f"{r.tokens[:12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
