"""Serving launcher of the port: load params from a train checkpoint
(``--ckpt``) or init them from a seed, run the event-loop serving
subsystem (EventLoopGroup of decode engines over the CommBackend wire
and a ring of peers), print the reference CLI's summary lines.

Counterpart of ``repro/launch/serve.py`` but for its pod flags (the pod
fabric is ROADMAP.md Queue 1 item 8). ``--supervised`` serves under the
self-healing supervisor (``serving/supervisor.py``: bounded admission,
retry/backoff healing, autoscaling between ``--event-loops`` and
``--max-loops``); ``--trace-out`` writes the run's span trace as
Chrome-trace JSON and ``--metrics-out`` the unified metrics snapshot
(``obs``). ``--tenant NAME=ARCH[:WEIGHT[:LOOPS]]`` (repeatable)
serves several models side by side in ONE group: each tenant owns a
contiguous run of LOOPS event loops and a WEIGHT share of the
weighted-fair dispatch, its params are initialised from ``--seed`` plus
its position, and requests alternate between the tenants; ``--ckpt``
serves one arch. Runs on the card unless ``--device cpu`` is given.

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
  # two families side by side, dispatched 2:1 (one loop each)
  python -m repro_torch.launch.serve --device cpu --requests 6 \
      --max-new 4 --tenant chat=qwen2-0.5b-reduced:2 \
      --tenant rnn=rwkv6-7b-reduced:1
  # self-healing supervisor, traced, with a metrics snapshot
  python -m repro_torch.launch.serve --arch qwen2-0.5b-reduced \
      --device cpu --requests 8 --max-new 4 --event-loops 1 \
      --supervised --max-loops 4 --scale-up-depth 4 \
      --admission-capacity 16 --dispatch-quantum 4 \
      --trace-out /tmp/trace.json --metrics-out /tmp/metrics.json

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
                                      ShapeConfig, TenantConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.backends import available_modes
from repro_torch.core.channels import Ring
from repro_torch.launch import steps
from repro_torch import obs
from repro_torch.models import api
from repro_torch.serving import (Request, RetryBudget, Supervisor,
                                 SupervisorConfig, make_engine_group)


def parse_tenant_specs(specs) -> tuple:
    """``NAME=ARCH[:WEIGHT[:LOOPS]]`` -> a tuple of TenantConfig."""
    out = []
    for spec in specs or ():
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise ValueError(
                f"--tenant {spec!r}: expected NAME=ARCH[:WEIGHT[:LOOPS]]")
        parts = rest.split(":")
        out.append(TenantConfig(
            name, arch=parts[0],
            weight=int(parts[1]) if len(parts) > 1 else 1,
            event_loops=int(parts[2]) if len(parts) > 2 else 1))
    return tuple(out)


def make_requests(cfg, n: int, *, max_new: int, temperature: float,
                  seed: int, min_len: int = 4, max_len: int = 32) -> list:
    """``n`` requests with prompt lengths drawn in ``[min_len, max_len)``
    and tokens drawn from the vocabulary, all from ``seed``. With ``cfg``
    a dict keyed by tenant name, request ``i`` goes to the tenant at
    ``i`` modulo their count (declaration order), its tokens from that
    tenant's vocabulary, as the reference's tenant mix."""
    rng = np.random.default_rng(seed)
    names = list(cfg) if isinstance(cfg, dict) else [""]
    reqs = []
    for i in range(n):
        name = names[i % len(names)]
        vocab = (cfg[name] if name else cfg).vocab_size
        reqs.append(Request(uid=i,
                            prompt=rng.integers(0, vocab,
                                                size=rng.integers(min_len,
                                                                  max_len)),
                            max_new=max_new, temperature=temperature,
                            tenant=name))
    return reqs


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
    p.add_argument("--arch", default="",
                   help=f"registry id: {', '.join(ARCH_IDS)}, each also "
                        "with -reduced (the CPU-sized variant); the "
                        "encdec and vlm frontends are stubs fed zeros. "
                        "Required unless --tenant is given")
    p.add_argument("--tenant", action="append", default=[],
                   metavar="NAME=ARCH[:WEIGHT[:LOOPS]]",
                   help="repeatable: serve several models in ONE group; "
                        "each tenant owns LOOPS event loops (a contiguous "
                        "range, disjoint channels) and a WEIGHT share of "
                        "the weighted-fair dispatch; requests alternate "
                        "between the tenants")
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
    # the self-healing supervisor (serving/supervisor.py)
    p.add_argument("--supervised", action="store_true",
                   help="run under the Supervisor: failure detection, "
                        "retry/backoff healing, elastic autoscaling and "
                        "admission backpressure")
    p.add_argument("--admission-capacity", type=int, default=64,
                   help="bounded admission queue; over capacity the "
                        "lowest-priority request is shed with an "
                        "explicit rejected outcome")
    p.add_argument("--dispatch-quantum", type=int, default=0,
                   help="requests dispatched per supervision round "
                        "(0 = drain the whole queue)")
    p.add_argument("--retry-limit", type=int, default=3,
                   help="drain retry attempts before a structured "
                        "retry_exhausted outcome")
    p.add_argument("--max-loops", type=int, default=0,
                   help="autoscale ceiling (0 = channel pool size); "
                        "--event-loops is the starting size")
    p.add_argument("--scale-up-depth", type=float, default=8.0,
                   help="queued requests per loop that votes to grow "
                        "the fleet")
    p.add_argument("--scale-down-depth", type=float, default=-1.0,
                   help="backlog per loop that votes to shrink "
                        "(negative disables shrinking)")
    # the telemetry plane (repro_torch/obs)
    p.add_argument("--trace-out", default="",
                   help="write a Chrome-trace/Perfetto JSON of the run's "
                        "spans here (enables tracing; tokens stay "
                        "bit-identical to an untraced run)")
    p.add_argument("--metrics-out", default="",
                   help="write the unified metrics snapshot (obs "
                        "registry JSON: poll/emission/loop/tenant/"
                        "supervisor counters) here")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) raises when no card is present")
    args = p.parse_args(argv)

    tenants = parse_tenant_specs(args.tenant)
    if not tenants and not args.arch:
        p.error("--arch is required (or pass one or more --tenant specs)")
    if tenants and args.supervised:
        p.error("--supervised requires a single-tenant group: tenant loop "
                "ranges pin the fleet size, which autoscaling would "
                "resize (drop --tenant or --supervised)")
    if tenants and (args.arch or args.ckpt):
        p.error("--tenant names each tenant's arch, and --ckpt serves one "
                "arch: drop --arch/--ckpt or --tenant")
    device = resolve_device(args.device)
    if tenants:
        cfg = {t.name: get_config(t.arch) for t in tenants}
        if args.event_loops == 1:      # default: the tenants' loops
            args.event_loops = sum(t.event_loops for t in tenants)
    else:
        cfg = get_config(args.arch)
    serve = ServeConfig(event_loops=args.event_loops, poll=args.poll,
                        max_batch=args.batch, max_len=args.max_len,
                        tenants=tenants,
                        comm=CommConfig(mode=args.comm_mode,
                                        channels=args.channels,
                                        aggregate=args.aggregate,
                                        flush=args.flush))
    if args.trace_out:
        obs.enable()
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
        if tenants:
            # one seeded init per tenant, as the reference's
            params = {t.name: api.init(torch.Generator(device=device)
                                       .manual_seed(args.seed + i),
                                       cfg[t.name], device=device)
                      for i, t in enumerate(tenants)}
        else:
            params = load_params(cfg, ckpt=args.ckpt, batch=args.batch,
                                 max_len=args.max_len, seed=args.seed,
                                 device=device, log=print if ring.rank == 0
                                 else lambda line: None)
        sup = None
        if args.supervised:
            sup = Supervisor(cfg, params, serve, device=device, ring=ring,
                             seed=args.seed, config=SupervisorConfig(
                                 admission_capacity=args.admission_capacity,
                                 dispatch_quantum=args.dispatch_quantum,
                                 max_loops=args.max_loops,
                                 scale_up_depth=args.scale_up_depth,
                                 scale_down_depth=args.scale_down_depth,
                                 retry=RetryBudget(limit=args.retry_limit)))
            group = sup.group
        else:
            group = make_engine_group(cfg, params, serve, seed=args.seed,
                                      device=device, ring=ring)
        reqs = make_requests(cfg, args.requests, max_new=args.max_new,
                             temperature=args.temperature, seed=args.seed)
        t0 = time.time()
        threads = args.event_loops > 1 and ring.world_size == 1
        if sup is not None:
            sup.submit(reqs)
            results = sup.run(threads=threads)
            group = sup.group          # may have been rebuilt by a resize
        else:
            group.submit(reqs)
            results = sorted(group.run(threads=threads),
                             key=lambda r: r.uid)
        dt = time.time() - t0
    finally:
        if own_group:
            dist.destroy_process_group()
        rec = obs.disable() if args.trace_out else None
    if ring.rank != 0:
        return 0
    tok = sum(len(r.tokens) for r in results)
    st = sup.poll_stats() if sup is not None else group.poll_stats()
    print(f"[serve] {len(results)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s) | {serve.event_loops} event loop(s), "
          f"poll={serve.poll} (spins={st.spins} parks={st.parks}), "
          f"comm={args.comm_mode}, ring={ring.world_size}, device={device}")
    if sup is not None:
        shed = sum(1 for o in sup.outcomes.values()
                   if o.status == "rejected")
        print(f"[serve] supervisor: {sup.rounds} rounds, "
              f"{len(sup.trace)} healing actions, {shed} shed, "
              f"fleet={sup.group.n_loops} loops, mttr="
              f"{sup.mttr_s() if sup.trace else None}")
        for a in sup.healing_trace():
            print(f"  heal round={a[0]} {a[1]} target={a[2]} {a[3]}")
    if tenants:
        print(f"[serve] tenants: fairness={group.fairness_counters} "
              f"dispatch={group.dispatch_log[:12]}")
    for loop in group.loops:
        print(f"  loop {loop.index}: channels={loop.channels} "
              f"results={len(loop.results)}")
    for r in results[:4]:
        print(f"  uid={r.uid} prompt_len={r.prompt_len} -> "
              f"{r.tokens[:12].tolist()}")
    if args.metrics_out:
        reg = obs.collect(group=group, supervisor=sup,
                          mode=args.comm_mode)
        with open(args.metrics_out, "w") as f:
            f.write(reg.to_json())
        snap = reg.snapshot()
        print(f"[serve] metrics snapshot -> {args.metrics_out} "
              f"({len(snap['counters']) + len(snap['gauges'])} "
              f"deterministic metrics)")
    if rec is not None:
        doc = rec.write(args.trace_out)
        print(f"[serve] span trace -> {args.trace_out} "
              f"({len(doc['traceEvents'])} spans, kinds={rec.kinds()})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
