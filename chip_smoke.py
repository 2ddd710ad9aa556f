#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases, one line each; any failed check raises and the script exits
non-zero (no phase's failure is caught):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   TF32 switched off for f32 products;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, one nvcc per source, all started together), report the
   seconds and ptxas' register report per kernel function, and check
   that no kernel spills and that the compiled code issues
   the asynchronous copies each design names (cuobjdump: HGMMA and
   UTMALDG in the bf16 flash kernels, UTMALDG in the chunked WKV6
   kernels and the RG-LRU TMA instance, LDGSTS in the RG-LRU cp.async
   instance);
3. hold each kernel against its plain PyTorch version on the card at
   the stated tolerances (flash attention at 3e-2/5e-2 in bf16, and
   every (batch, position, head) row of the output within 2e-2 rel_l2
   of the plain version's, a bound only rounding meets (a plain version
   missing one 64-key tile lands past it at mixtral's S=4090, checked);
   2e-4/2e-3 in f32, head dims 16..256; ring pack and unpack bit for bit,
   ``torch.equal`` on the bit patterns; WKV6 at 2e-3, 5e-3 at extreme
   decays, every head size on both sides of the chunk and the
   decode-kernel threshold, chained calls; RG-LRU at 2e-4 on both load
   paths, ragged W, a misaligned base, chained calls), then time kernel,
   plain version and the one PyTorch library call that computes the same
   function, at the shapes the main paths give them, beside the roofline
   bound (flash also at phase 7's Dh-128 shapes: B=2, S=1024, (H, KV) =
   (20, 20), (24, 2), (48, 8), (64, 8), and S=4096 and mixtral's served
   S=4090, (32, 8) window 4096; and at phase 8's: whisper-tiny's
   encoder, B=2, S=1500, H=KV=6, Dh=64 non-causal, against SDPA with
   ``is_causal=False``, and llava's prefill, B=2, S=3904, (32, 8),
   Dh=128 causal).
   Every timing is queued behind a device-side spin, so it times
   the card, not the host's launch rate (the WKV6 decode step, ~3 us, over
   500 calls);
4. serve qwen2-0.5b at full width (random weights from a seed) through
   ``make_engine_group`` -> ``EventLoopGroup`` -> ``DecodeEngine`` ->
   ``dispatch.ServeStep``: 8 requests, prompts of 16..1024 tokens, 16
   new tokens each, 2 decode slots per loop (so continuous admission
   runs), 2 event loops, busy polling, greedy. Checks every request's
   token count, that every prefill went through the kernel (launch
   counter), that served first tokens replay from the kernel-path
   logits, and that those logits match the plain-attention path;
4b. serve the same requests over a ring of peers: a one-peer NCCL group
   (``HashStore``), one ``Ring`` of 4 channel communicators, shared by
   phases 4b-9. ``hadronio`` through the sliced serving wire
   (``pipeline.emit_flat``: the prefill's gathering write and the decode
   logit reduction carved into 4 MiB ring slices, each an NCCL
   collective on its loop's own channel), 2 threaded loops, busy polling,
   first ``aggregate=slice, flush=step``, then ``channel, ready``.
   Checks that the tokens equal phase 4's exactly, that every decode
   step issued ``logit_payload_slices`` all-reduces (counted by wrapping
   the ``torch.distributed`` functions here) and that every prefill ran
   the flash kernel per layer; times prefill (B=2, S=1024) and decode
   (B=2), wall and device (profiler), for ``gspmd`` (the pure local
   path), ``sockets``, ``vma`` and ``hadronio`` at 4 MiB and 256 KiB
   slices;
5. train qwen2-0.5b at full width (random weights from seed 0) through
   ``launch.train.Trainer`` -> ``steps.make_train_step`` ->
   ``tac.sync_grads`` -> ``HadronioBackend.sync`` ->
   ``pipeline.pack_wire`` + ``pipeline.reduce_wire`` (ring-pack kernel
   -> one NCCL all-reduce per slice through 4 channel communicators ->
   unpack kernel) ->
   AdamW, on the one-peer NCCL group: synthetic data from seed 0,
   ``seq_len`` 1024, ``global_batch`` 4, 5 steps, ``hadronio`` with
   ``compress=bf16``, ``pack=pallas``, ``aggregate=slice``,
   ``flush=step``. Checks finite and falling loss, one pack and one
   unpack launch per step and no flash launch; then syncs one real
   full-width gradient with ``pack=pallas`` and ``pack=jnp``, as it is
   (bf16, exact on the wire, zero EF) and in f32 with a nonzero EF,
   and checks each pair bitwise equal; trains ``vma/bf16/pallas`` (one
   all-reduce of the packed bf16 wire a step) and checks one pack and one
   unpack launch per step;
5c. the rest of the hadronio family: syncs the same two real gradients
   through ``hadronio_rs`` (per-slice reduce-scatter, ZeRO-1),
   ``hadronio_overlap`` (11 reverse-layer buckets of 4 MiB) and
   ``hadronio_overlap_rs`` (the buckets reduce-scattered) with
   ``pack=pallas`` and ``pack=jnp`` and checks each pair bitwise equal,
   and each mode's ``gathered_grads`` bitwise equal to ``hadronio``'s
   synced tree (at one peer a reduce-scatter is a copy); holds the ring
   kernels against their plain versions at the smallest and largest
   bucket shapes, (1, 1024) and (1, 136134656), and times them beside
   their bytes bound; trains each of ``FAMILY_RUNS`` 5 steps
   (``bf16``/``pallas``; ``hadronio_overlap_rs`` under ``slice, step``
   and ``channel, ready``) and checks finite, falling losses, the pack
   and unpack launches per step (``hadronio_rs`` 1 and 1; the overlap
   modes one pack per bucket and one unpack per flush: 11, or 4 under
   ``channel, ready``) and no flash launch, with the peak memory. Then
   times steps 2-5 for ``hadronio/bf16/pallas``, ``hadronio/bf16/jnp``,
   ``vma/bf16/pallas``, ``sockets`` (one all-reduce per gradient
   tensor), ``gspmd`` and the four family runs from one start state;
   profiles one step of each; reports peak memory;
5d. the fault-tolerant trainer, on the same ring, ``hadronio/bf16/pallas``
   at B=4, S=1024, seed 0: writes a token shard (8 M uint16 tokens from
   a numpy generator, seed 0, with its ``.meta``) into a temporary
   directory (after printing its ``df`` and checking it has room for
   three checkpoints) and trains from it (``--data``); 3 steps at
   ``microbatches`` 1 and 2 from one start state, checking finite,
   falling losses, one pack and one unpack launch per step at both and
   a lower peak memory at 2; then the main path, ``train_with_restarts``
   for 4 steps at ``microbatches=2`` with asynchronous checkpoints every
   2 steps (keep 2) and ``REPRO_FAULT_AT_STEP=3``: checks one restart,
   the state restored from step 2 bitwise equal to the live state saved
   there (params, moments, count, EF), the final loss within 1e-5 of an
   uninterrupted run, and reports whether the final params are bitwise
   equal; saves and restores a ``hadronio_rs`` state (flat ZeRO-1
   moments) at ring size 1, bitwise; reports checkpoint bytes, blocking
   save, snapshot and restore seconds, and the step time with an
   asynchronous save in flight against without. Each Trainer is closed
   after use (its channel communicators destroyed), and the cache is
   emptied before each new ring, whose communicators NCCL allocates
   outside PyTorch's allocator; ``[memory]`` lines print the card's free
   memory there. The directory (with the checkpoint phase 9 serves) is
   removed when the script exits, whatever happened;
6. serve rwkv6-7b (WKV6 kernel) and recurrentgemma-9b (RG-LRU kernel,
   flash at head_dim 256) at full width, bf16, random weights from the
   card's generator, through the same path: 8 requests in four pairs of
   equal prompt length (one pair per loop, so the recurrent engine's
   equal-length buckets form B=2 waves), 16 new tokens each, greedy,
   ``--batch 2``, 2 event loops, busy polling, ``gspmd`` at ring size 1.
   rwkv6 prompts are 1024, 640, 384 and 128 tokens (``--max-len 2048``);
   recurrentgemma's 2040, 1024, 384 and 128 (``--max-len 4096``), so
   decode crosses the 2048-slot local window. Checks every request's
   token count; that every WKV scan (32 per prefill call and per decode
   step), every multi-step RG-LRU scan (26 per prefill call) and every
   local-attention prefill (12 per call) went through its kernel (launch
   counters); that served first tokens replay from the kernel path's
   logits; for recurrentgemma, that the bf16 kernel path's prefill
   logits at full width land no farther from the f32 plain path's than
   twice the bf16 plain path, plus 5e-3, and that its prefill trace names
   the tensor-core flash kernel; and that at f32, full width and 4
   layers, the kernel path's prefill logits are within 1e-4 relative L2
   of the plain path's. Then serves the longest pair again through
   ``hadronio`` over the ring and checks the same tokens and launch
   counts. Reports prefill (B=2, S=1024) and decode (B=2) times, host
   and device, and peak memory;
7. the decoder-only families at full width, bf16, random weights from
   the card's generator, memory released before each: qwen1.5-4b (40
   layers) and starcoder2-3b (30 layers) whole, serving phase 4's 8
   prompts (874..283 tokens), 16 new tokens each, ``--batch 2``, 2 event
   loops, busy polling, ``gspmd``; qwen1.5-110b at 4 of 80 layers, one
   prefill (B=2, S=1024) and 16 decode steps through the serve step;
   mixtral-8x7b at 16 of 32 layers (pairs of 4090, 1024, 384 and 128
   tokens, ``--max-len 8192``: the longest pair decodes past the
   4096-slot rolling window) and dbrx-132b at 4 of 40 layers (pairs of
   1024 and 128 tokens). Checks every request's token count, one flash
   launch per layer per prefill call, that served first tokens replay
   from the kernel path's logits, and for the dense models phase 4's
   logit rule (f32 kernel vs plain within 1e-3 rel_l2, bf16 kernel no
   farther from f32 than twice the bf16 plain path plus 5e-3). For every
   model the first layer's bf16 attention output on the served batch,
   kernel against plain, within phase 3's 2e-2 per-row bound. For the
   moe models: one layer's block time against its expert GEMMs; the
   longest pair again through ``hadronio`` over the ring, where the
   expert stage runs expert-parallel through the ``all_to_all`` wire
   (``all_to_all_single`` counted: 2 x the plan's slices per moe layer
   per call), with how far its prefill logits land from the local path's
   (f32 experts there, bf16 here: reported, not bounded); and at f32,
   full width and 2 layers the exchange path's prefill logits, KV cache
   and decode logits bitwise equal to the local path's, the kernel path
   within 1e-3 rel_l2 of the plain one. Reports prefill (B=2, S=1024) and
   decode (B=2) times, wall and device, kernels, busy share and peak
   memory of each model (of the exchange path too);
8. the encoder-decoder and vision-prefix families at full width, bf16,
   random weights from the card's generator, memory released before
   each: whisper-tiny (4 encoder + 4 decoder layers, 1500 frames) and
   llava-next-mistral-7b (32 layers, 2880 patches) whole, serving phase
   4's 8 prompts, 16 new tokens each, ``--batch 2``, 2 event loops, busy
   polling, ``gspmd``, ``--max-len 2048``; the engine feeds the stub
   frontends' zero frames or patches. Checks every request's token
   count; the flash launches of every prefill call, recorded per call
   (whisper: 4 non-causal at S=1500 in the encoder and 4 causal in the
   decoder; llava: 32 causal at S = 2880 + prompt); served first tokens
   replayed from the kernel path's logits (the reference's first-token
   rows: the batch's last position for whisper, row ``len - 1`` of the
   prefixed sequence for llava); the first layer's bf16 attention on the
   served batch (whisper's encoder, non-causal) within phase 3's row
   bound; phase 4's logit rule, whisper whole and llava at 4 layers; the
   longest pair again through ``hadronio`` over the ring, with the same
   tokens and launches. Reports prefill (B=2, 1024 tokens plus the
   frames or patches) and decode (B=2) times, wall and device, kernels,
   busy share and peak memory;
9. train the families (``api.loss`` of every family in its train mode,
   which launches no kernel): mixtral-8x7b at 1 of 32 layers (B=4,
   S=1024), rwkv6-7b at 4 of 32 and recurrentgemma-9b at 3 of 38 (one
   whole group, with its whole untied 256,000-row vocabulary) at B=2,
   S=512, full width, bf16, 3 steps each through a donating ``Trainer``
   (its steps update the state in place, as the CLI's and the
   reference's do) with ``hadronio``/``bf16``/``pallas`` on the one-peer
   ring. Checks finite losses, one pack and one unpack launch a step and
   no flash, WKV6 or RG-LRU launch; reports the median step time, one
   profiled step (device time, kernels, busy share) and the peak memory
   beside the step's reckoned state. Then at each of moe, ssm, hybrid,
   encdec and vlm's ``-reduced`` configs (f32) the card's loss, aux and
   every gradient leaf against the port's CPU run on the same params
   and batch (atol = rtol = 1e-4), and whisper-tiny whole (1500 frames,
   the encoder in train mode) through one loss and backward: finite, no
   flash launch. Last, ``launch.serve --ckpt`` serves qwen2-0.5b from
   phase 5d's checkpoint: the restored params bitwise equal to its
   files, the restore line printed, 4 requests served with flash in
   every prefill, their tokens equal to an in-process engine group's on
   the same restored params, whose prefill logits are finite;
10. multi-tenant serving and the chaos plane: (a) qwen2-0.5b (tenant
   ``chat``, weight 2) and rwkv6-7b (``rnn``, weight 1) whole, at full
   width, bf16, in ONE event-loop group (``gspmd``, busy polling,
   threaded drains, one loop each): 6 requests alternating between the
   tenants, 8 new tokens each. Checks the dispatch log (the stride
   sequence chat chat rnn chat rnn rnn) and fairness counters, each
   tenant's tokens against a single-tenant group's on the same params
   and requests, one flash launch per layer per qwen prefill and one
   WKV6 launch per layer per rwkv prefill and decode step; then
   ``launch.serve --tenant chat=qwen2-0.5b:2 --tenant rnn=rwkv6-7b:1``
   as a subprocess, its fairness line checked. (b) the chaos harness
   (``serving/chaos.py``) on qwen2-0.5b whole through ``hadronio`` over
   phase 4b's ring at 4 MiB slices, 4 channels, ``aggregate=channel``,
   ``flush=ready``, 2 loops drained inline: a fault-free baseline of 8
   requests (prompts 64..512 tokens, 8..16 new tokens; run twice, the
   second timed), then each of the six scenarios at seed 11 and
   ``dropped_flush`` again. Checks
   every scenario's tokens against the baseline, a non-empty fired
   trace, one flash launch per layer per prefill call (storm admissions
   included), and per scenario the stalls, delays, drops, allocations,
   migrated channels and storm uids; the replay's fired and drain
   traces identical. Prints each scenario's RTT p50/p99/p99.9, its
   p99.9 inflation over the baseline and its wall time;
11. the self-healing supervisor and the telemetry plane, on phase 10b's
   model, params, serve shape, requests and baseline: (a) each of the six
   scenarios through ``chaos.run_supervised`` (``dropped_flush`` twice):
   tokens recovered, every client uid ``served``, a non-empty healing
   trace with the scenario's kind (quarantine, quarantine, retry,
   backpressure, resize, retry), the replay's trace identical, one flash
   launch per layer per prefill call; (b) a traced baseline (three times,
   in turns with three untraced runs, and one span's host cost: the
   tracing overhead) and a traced
   supervised ``dropped_flush``: every span kind (emission, stage,
   flush, build, prefill, decode, admission, drain, heal), well-formed,
   no span evicted, tokens unchanged, the Chrome-trace JSON written
   under ``build/`` loading back; (c) two seeded supervised runs give
   byte-identical deterministic metrics snapshots (``obs.collect``); (d)
   ``launch.serve --supervised --trace-out --metrics-out`` as a
   subprocess, rc 0, both files loaded. Prints per scenario the wall
   time, RTT p50/p99.9, the healing actions and MTTR, and span counts by
   kind;
12. the two-level pod fabric (``serve_pods``), on phase 10b's model,
   params, requests and baseline, over a second ring on the one-peer
   NCCL group, ``Ring(channels=4, pods=1, pod_axis="pod")`` (the
   reference's ``(1, 1)`` pod mesh: an in-pod and a cross-pod
   communicator beside each channel's, built after ``release_memory``
   and closed after the phase), ``hadronio``, 4 channels,
   ``channel``, 512 KiB slices, ``leader_channels=1``: (a) 2 loops under
   ``ready`` (in turns with the flat emission on the same ring) and
   ``step``: tokens bitwise phase 10b's, flash 24 per prefill call, and
   on the collective hook every decode emission ``in_pod_reduce_scatter``
   -> ``cross_pod_all_reduce`` -> ``in_pod_all_gather`` and every prefill
   emission ``in_pod_all_gather`` -> ``cross_pod_all_gather`` (one
   cross-pod collective per emission; the flat emission issues two, one
   per lane of the loop); (b) 4 loops, one lane each: the channel's own
   two-level all-reduce, tokens bitwise; (c) (a) traced: every
   ``leader_flush`` inside a ``flush`` of its own emission,
   well-formed, none evicted; (d) walls on the host clock beside phase
   10b's flat baseline, the flash count, the card's free memory and
   PyTorch's peak before and after the pod ring's communicators;
13. the analysis layer (``launch/hlo_analysis``) and the dry run
   (``analysis_phase``): (a) phase 5's step (qwen2-0.5b, S=1024, B=4,
   ``hadronio``, ``bf16``, ``pallas``) recorded once through a new
   ``Trainer``: its collectives by kind and result bytes those of the
   ring plan (one all-reduce per slice of bf16 wire, and the loss's), one
   pack and one unpack launch; its counted FLOPs against ``model_flops``,
   its memory, the median of steps 2-5 unrecorded, ``roofline_terms`` and
   the compute share at the data sheet's bf16 peak; (b) on phase 4b's
   ring with phase 10b's params, a recorded ``hadronio`` prefill (B=2,
   S=1024) and decode step, each with its first collective inside the op
   stream, 24 flash launches in the prefill, ``gspmd``'s local decode
   with no collective; (d) two ``hadronio_rs`` steps on
   ``Ring(channels=4, pods=1, pod_axis="pod")`` and on a flat ring,
   losses bitwise equal; (c) meanwhile, as subprocesses started after
   (a)'s timing, the dry run of qwen2-0.5b x train_4k: ``hadronio`` on
   256 fake peers, on 2 pods of 256 (global batch 512, ``channel``) with
   the leader emission and flat, all ``ok``, the leader emission issuing
   fewer cross-pod collectives than the flat one, and ``gspmd`` recorded
   as ``fail`` with its named error; each run's seconds and memory
   estimate printed;
14. the ``kernels`` JSON line, then the final ``ok`` JSON line.

Exits non-zero without a result when CUDA is not available.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the card's data-sheet peaks, from the analysis layer (one source)
from repro_torch.launch import hlo_analysis as _hlo  # noqa: E402

H100_BF16_FLOPS = _hlo.PEAK_FLOPS   # dense tensor-core peak (SXM)
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores
H100_BYTES_S = _hlo.HBM_BW          # HBM3


def time_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False,
            label: str = "") -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.
    ``queued``: the calls are queued behind a device-side spin that
    outlasts their host side (Python, the wrapper's checks, the launch),
    sized from one call's host time, so the card does not idle between
    kernels: the events time the card's work, not the host's launch rate.
    If the spin had already ended when the last call was queued, the
    timing is taken again behind a spin four times as long (twice at
    most, and not past a 0.5 s spin, which the launch queue would not
    outlast); a timing the host still outran is named (``label``) on a
    ``[time-queue]`` line."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_s = 0.0
    if queued:
        t0 = time.perf_counter()
        fn()
        spin_s = max(0.01, 2.5 * iters * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    for _ in range(3):
        if queued:
            # cycles at the card's top clock (1.98 GHz); slower clocks
            # only lengthen the spin
            torch.cuda._sleep(int(spin_s * 1.98e9))
        start.record()
        for _ in range(iters):
            fn()
        outran = queued and start.query()
        end.record()
        end.synchronize()
        if not outran or spin_s >= 0.5:
            break    # a longer spin would not outlast the launch queue
        spin_s *= 4
    if outran:
        print(f"[time-queue] {label or getattr(fn, '__name__', 'fn')}: "
              f"the host outran a {spin_s:.3f} s spin; this time includes "
              "host pace")
    return start.elapsed_time(end) / iters


def profile_device(fn, top: int = 6):
    """Kernel time of one ``fn`` call from the profiler's device trace:
    (summed kernel ms, kernel count, [(name, ms)] of the ``top`` kernel
    names by time, {name: ms} of all). An empty trace returns
    (None, 0, [], {})."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not n:
        return None, 0, [], {}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), n, ranked, by_name


def attn_bound_ms(b, s, h, dh, causal, window, elem_bytes, peak_flops,
                  kv_heads=None):
    """Least time for one attention call: the larger of its FLOPs (two
    products over the (q, k) pairs the masks keep) over the peak rate and
    its bytes (q read once and o written once at ``h`` heads, k and v read
    once at ``kv_heads``, default ``h``) over the memory rate."""
    kv = h if kv_heads is None else kv_heads
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= (q - k) < window
    flops = 4.0 * b * h * dh * int(keep.sum())
    nbytes = 2.0 * b * s * (h + kv) * dh * elem_bytes
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def check_bitwise(name, pairs) -> float:
    """``pairs``: (got, want) tensors that must agree bit for bit.
    Returns the largest |got - want| over the pairs (0.0 when they
    agree), measured, not assumed."""
    ok = all(g is None and w is None or (
        g is not None and w is not None and g.shape == w.shape
        and g.dtype == w.dtype and torch.equal(bits(g), bits(w)))
        for g, w in pairs)
    max_err = max((float((g.float() - w.float()).abs().max())
                   for g, w in pairs if g is not None and w is not None
                   and g.shape == w.shape), default=0.0)
    print(f"[check] {name}: bitwise {'ok' if ok else 'FAIL'} "
          f"(max_abs_err={max_err:.3e})")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def check_close(name, got, want, atol, rtol, verbose=True) -> float:
    """|got - want| <= atol + rtol |want| everywhere and got finite;
    prints one line (only on failure when not ``verbose``), raises on
    failure, returns the largest |got - want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_err = float(err.max())
    ok = bool(torch.isfinite(got).all()) and worst <= atol
    if verbose or not ok:
        print(f"[check] {name}: max_abs_err={max_err:.3e} "
              f"(atol={atol}, rtol={rtol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


ROW_BOUND = 2e-2    # bf16 flash, per output row; rounding alone ~5e-3


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest rel_l2 over the last dim: each (batch, position, head)
    row of an attention output against its plain version's. A late row
    averages thousands of keys, so its values are small; an elementwise
    atol as large as those values would pass a kernel that drops keys."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def check_rows(name, got, want, verbose=True) -> float:
    """Every row of ``got`` within ``ROW_BOUND`` rel_l2 of ``want``'s
    and finite; raises otherwise, returns the worst row's error."""
    err = row_err(got, want)
    ok = bool(torch.isfinite(got).all()) and err <= ROW_BOUND
    if verbose or not ok:
        print(f"[check] {name}: worst row rel_l2={err:.3e} (bound "
              f"{ROW_BOUND}), whole rel_l2={rel_l2(got, want):.3e} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def check_prefill_flash(label: str, by_name: dict) -> None:
    """A prefill trace's flash kernels: the tensor-core kernel runs, and
    no FMA flash kernel (the f32 one) appears."""
    tc = {n: ms for n, ms in by_name.items() if "flash_fwd_tc" in n}
    fma = [n for n in by_name if "flash_fwd_f32" in n]
    print(f"[profile] {label} prefill flash kernels: "
          + "; ".join(f"{n[:72]} {ms:.3f} ms" for n, ms in tc.items())
          + f" | FMA flash kernels: {len(fma)}")
    if not tc or fma:
        raise AssertionError(f"{label}: prefill did not run the tensor-core "
                             f"flash kernel alone ({sorted(by_name)[:8]})")


def spill_lines(ptxas_log: str) -> list:
    """The lines of a ptxas report that count spilled bytes."""
    return [line.strip() for line in ptxas_log.splitlines()
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]


def ptxas_report(ptxas_log: str) -> list:
    """(kernel function, line) for the lines of a ptxas report that give
    registers, spills, wgmma notes or warnings."""
    fn, out = "?", []
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        if any(w in line for w in ("registers", "spill", "wgmma", "arning")):
            out.append((fn, line.strip()))
    return out


def sass_counts(path: str) -> dict:
    """{kernel function: {instruction: count}} of the HGMMA (wgmma),
    UTMALDG (TMA load) and LDGSTS (cp.async) instructions in a built
    library, from cuobjdump; None when the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", path], check=True,
                         capture_output=True, text=True).stdout
    counts: dict = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG", "LDGSTS"):
                if op in line:
                    word = next(w for w in line.replace(";", " ").split()
                                if w.startswith(op))
                    counts[fn][word] = counts[fn].get(word, 0) + 1
    return counts


def scan_bound_ms(nbytes: float, flops: float):
    """Least time of an f32 scan: bytes over the HBM rate or FLOPs over
    the f32 rate (the scans use no tensor cores), whichever is larger."""
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wkv6_inputs(gen, b, t, h, hs, extreme=None):
    """r, k, v, w, u, s0 as the reference's kernel tests draw them: s0 != 0,
    decays in (0.1, 0.95); ``extreme="steps"``: the first half of the
    steps decay at 1e-6, the rest at 1 - 1e-6, s0 = 0 (the reference's
    case); ``extreme="channels"``: channels alternate 1e-6 / 1 - 1e-6 at
    every step, s0 != 0 (extreme decays at any T, the decode step's 1)."""
    dev = torch.device("cuda")
    n = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    r, k, v = n(b, t, h, hs), n(b, t, h, hs), n(b, t, h, hs)
    s0 = n(b, h, hs, hs) * 0.1
    if extreme == "steps":
        w = torch.full((b, t, h, hs), 1 - 1e-6, device=dev)
        w[:, : t // 2] = 1e-6
        s0 = torch.zeros_like(s0)
    elif extreme == "channels":
        w = torch.full((b, t, h, hs), 1 - 1e-6, device=dev)
        w[..., ::2] = 1e-6
    else:
        w = torch.sigmoid(n(b, t, h, hs)) * 0.85 + 0.1
    return r, k, v, w, n(h, hs) * 0.1, s0


def rglru_inputs(gen, b, t, w):
    dev = torch.device("cuda")
    n = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    return torch.sigmoid(n(b, t, w)) * 0.95, n(b, t, w), n(b, w)


def serve_recurrent(gen, smi, arch, lens, max_len, expect, plain, ring):
    """Phase 6 for one model: serve ``arch`` at full width through the
    event-loop group on the card, then its longest pair again through
    the hadronio wire over ``ring``; ``expect`` maps a wrapper to its
    launches per prefill call and per decode step; ``plain`` is the
    prefill keywords of the plain path. Returns the launches by
    wrapper, both runs together."""
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    from repro_torch.serving import Request, make_engine_group
    dev = gen.device
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = api.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[init] {cfg.name}: {cfg.param_count() / 1e9:.3f}B params "
          f"{cfg.param_dtype} in {time.perf_counter() - t0:.2f}s")
    serve = ServeConfig(event_loops=2, poll="busy", max_batch=2,
                        max_len=max_len, comm=CommConfig(mode="gspmd",
                                                         channels=4))
    group = make_engine_group(cfg, params, serve, seed=0, device=dev)
    rng = np.random.default_rng(0)
    # pairs of equal length, one pair per loop (round-robin by uid)
    order = [lens[0], lens[1], lens[0], lens[1],
             lens[2], lens[3], lens[2], lens[3]]
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=16) for i, n in enumerate(order)]
    wrappers = (ops.wkv6, ops.rglru, ops.flash_attention)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for wrapper in wrappers:
        wrapper.launches = 0
    t0 = time.perf_counter()
    group.submit(reqs)
    results = sorted(group.run(threads=True), key=lambda r: r.uid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {w.__name__: w.launches for w in wrappers}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engines = [l.engine for l in group.loops]
    prefills = sum(e.prefills for e in engines)
    decodes = sum(e.decode_steps for e in engines)
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve] {cfg.name}: {len(results)} requests (prompts "
          f"{order}), {n_tok} tokens in {dt:.3f}s = {n_tok / dt:.1f} "
          f"tok/s | prefill calls {prefills}, decode steps {decodes}, "
          f"launches {got} | peak memory {peak_gb:.2f} GB ({base_gb:.2f} "
          f"GB allocated before the run) | {smi}")
    assert [r.uid for r in results] == list(range(len(reqs)))
    assert all(len(r.tokens) == 16 for r in results), \
        [len(r.tokens) for r in results]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    assert prefills == 4 and sum(e.admit_prefills for e in engines) == 0
    def expected(prefills, decodes):
        want = {w.__name__: 0 for w in wrappers}
        for name, (per_prefill, per_decode) in expect.items():
            want[name] = per_prefill * prefills + per_decode * decodes
        return want
    assert got == expected(prefills, decodes), (got, expected(prefills,
                                                              decodes))

    # the longest pair (uids 0 and 2, one B=2 wave on loop 0 above)
    # through the sliced hadronio wire over the ring: the same tokens,
    # every scan and attention still through its kernel
    wired = make_engine_group(cfg, params, ServeConfig(
        event_loops=1, poll="busy", max_batch=2, max_len=max_len,
        comm=CommConfig(mode="hadronio", channels=4)), seed=0, device=dev,
        ring=ring)
    for wrapper in wrappers:
        wrapper.launches = 0
    t0 = time.perf_counter()
    wired.submit([reqs[0], reqs[2]])
    wired_res = sorted(wired.run(threads=False), key=lambda r: r.uid)
    torch.cuda.synchronize()
    dt_w = time.perf_counter() - t0
    got_w = {w.__name__: w.launches for w in wrappers}
    eng = wired.loops[0].engine
    print(f"[serve-ring] {cfg.name} hadronio over a ring of "
          f"{ring.world_size}: uids 0, 2 (prompts {order[0]}) in "
          f"{dt_w:.3f}s, prefill calls {eng.prefills}, decode steps "
          f"{eng.decode_steps}, launches {got_w} | {smi}")
    assert [r.tokens.tolist() for r in wired_res] == \
        [results[0].tokens.tolist(), results[2].tokens.tolist()], \
        "hadronio-served tokens differ from gspmd's"
    assert eng.prefills == 1 and got_w == expected(1, eng.decode_steps), \
        (got_w, expected(1, eng.decode_steps))
    got = {name: n + got_w[name] for name, n in got.items()}
    del wired, eng

    # device time of the serve step at B=2, S=1024, and of a decode
    # step at B=2 against that prefill's state
    step = group.loops[0].engine.step
    big = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, 1024)), device=dev)}
    ms_prefill = time_ms(lambda: step.prefill(params, big), iters=3,
                         warmup=1)
    _, cache = step.prefill(params, big)
    dec = {"token": torch.zeros(2, dtype=torch.long, device=dev),
           "pos": torch.tensor([1024, 1024], device=dev)}
    ms_decode = time_ms(lambda: step.decode(params, cache, dec),
                        iters=10)
    print(f"[serve-time] {cfg.name}: prefill B=2 S=1024 "
          f"{ms_prefill:.3f} ms | decode step B=2 {ms_decode:.3f} ms | "
          f"{smi}")
    for what, fn, wall in (
            ("prefill", lambda: step.prefill(params, big), ms_prefill),
            ("decode", lambda: step.decode(params, cache, dec),
             ms_decode)):
        busy, n_k, ranked, by_name = profile_device(fn)
        if busy is None:
            print(f"[profile] {cfg.name} {what}: device time not "
                  "measured (the profiler recorded no device events)")
            continue
        scans = {name: ms for name, ms in by_name.items()
                 if "wkv6_" in name or "rglru_fwd" in name}
        print(f"[profile] {cfg.name} {what}: {n_k} kernels, {busy:.3f} "
              f"ms on the device of {wall:.3f} ms per step "
              f"({busy / wall:.1%} busy); top: "
              + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in ranked)
              + " | scan kernels: " + ("; ".join(
                  f"{name[:60]} {ms:.3f}" for name, ms in scans.items())
                  or "none"))
        if what == "prefill" and "attend" in plain:
            check_prefill_flash(cfg.name, by_name)
    del cache

    # loop 0's longest wave (uids 0 and 2) replays its served first
    # tokens from the kernel path's prefill logits
    batch = {"tokens": torch.as_tensor(
        np.stack([reqs[0].prompt, reqs[2].prompt]), device=dev)}
    lk, _ = step.prefill(params, batch)
    first = lk.argmax(-1).tolist()
    assert first == [int(results[0].tokens[0]),
                     int(results[2].tokens[0])], \
        (first, results[0].tokens[:1], results[2].tokens[:1])
    assert lk.shape == (2, cfg.vocab_size) \
        and bool(torch.isfinite(lk).all())
    if "attend" in plain:
        # bf16 prefill logits at full width against the same weights run in
        # f32 through the plain path, as qwen2-0.5b's check: the kernel
        # path must land no farther than twice the bf16 plain path, plus
        # 5e-3. A wrong attention kernel misses it by O(1)
        lp, _ = api.prefill(params, batch, cfg, **plain)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        l32, _ = api.prefill(p32, batch, cfg32, **plain)
        del p32
        ek, ep = rel_l2(lk, l32), rel_l2(lp, l32)
        ok = ek <= 2 * ep + 5e-3
        print(f"[check] {cfg.name} bf16 prefill logits of "
              f"{tuple(batch['tokens'].shape)}: vs f32 rel_l2 kernel="
              f"{ek:.3e} plain={ep:.3e} (bound 2x plain + 5e-3); bf16 "
              f"kernel vs plain max_abs_err="
              f"{float((lk.float() - lp.float()).abs().max()):.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{cfg.name}: bf16 prefill logits of the "
                                 "kernel path disagree with the plain path")
        del lp, l32
    del group, step, params, lk
    torch.cuda.empty_cache()

    # f32, full width, 4 layers: the kernel path against the plain
    # path on the same weights and prompts. They differ only in the
    # order of sums (1e-6 relative per layer), so the bound is 1e-4
    # relative L2; a wrong kernel misses it by O(1)
    cfg4 = dataclasses.replace(cfg, num_layers=4, param_dtype="float32",
                               compute_dtype="float32")
    p4 = api.init(gen, cfg4, device=dev)
    lk4, _ = api.prefill(p4, batch, cfg4)
    lp4, _ = api.prefill(p4, batch, cfg4, **plain)
    torch.cuda.synchronize()
    e4 = float((lk4 - lp4).norm() / lp4.norm())
    print(f"[check] {cfg.name} f32 4 layers, prefill logits of "
          f"{tuple(batch['tokens'].shape)}: kernel vs plain rel_l2="
          f"{e4:.3e} (bound 1e-4), max_abs_err="
          f"{float((lk4 - lp4).abs().max()):.3e} "
          f"{'ok' if e4 <= 1e-4 else 'FAIL'}")
    if not e4 <= 1e-4:
        raise AssertionError(f"{cfg.name}: kernel path disagrees with "
                             "the plain path")
    del p4, lk4, lp4
    torch.cuda.empty_cache()
    return got


class CollectiveCount:
    """Counts the ``torch.distributed`` collectives the serving wire
    issues (``all_reduce``, ``all_gather_into_tensor``, and the moe
    expert exchange's ``all_to_all_single``), by wrapping the module's
    functions, which the port calls through the module at call time.
    Thread-safe: the threaded event loops count together."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_to_all_single")

    def __init__(self):
        import threading
        import torch.distributed as dist
        self.lock = threading.Lock()
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.saved = {name: getattr(dist, name) for name in self.NAMES}
        for name, fn in self.saved.items():
            setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            with self.lock:
                self.counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    def reset(self) -> None:
        with self.lock:
            self.counts = dict.fromkeys(self.NAMES, 0)

    def restore(self) -> None:
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def serve_over_ring(smi, cfg, params, reqs, want_tokens, ring, big, cache,
                    dec):
    """Phase 4b: serve phase 4's requests through the sliced hadronio
    wire over ``ring`` (2 threaded loops, each on its own 2 channel
    communicators), under two schedules; the tokens must be phase 4's
    (``want_tokens``, by uid), every decode step must issue
    ``logit_payload_slices`` all-reduces per loop's channel budget, and
    every prefill must launch the flash kernel once per layer. Then time
    prefill (``big``) and decode (``cache``, ``dec``) of every mode at two
    slice sizes, wall and device. Returns the flash launches of the
    served runs."""
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import dispatch, make_engine_group
    dev = big["tokens"].device
    count = CollectiveCount()
    flash = 0
    try:
        for aggregate, flush in (("slice", "step"), ("channel", "ready")):
            serve = ServeConfig(event_loops=2, poll="busy", max_batch=2,
                                max_len=2048, comm=CommConfig(
                                    mode="hadronio", channels=4,
                                    aggregate=aggregate, flush=flush))
            group = make_engine_group(cfg, params, serve, seed=0,
                                      device=dev, ring=ring)
            ops.flash_attention.launches = 0
            count.reset()
            t0 = time.perf_counter()
            group.submit(reqs)
            results = sorted(group.run(threads=True), key=lambda r: r.uid)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = ops.flash_attention.launches
            counts = dict(count.counts)
            flash += launches
            engines = [l.engine for l in group.loops]
            prefills = sum(e.prefills for e in engines)
            decodes = sum(e.decode_steps for e in engines)
            n_slices = dispatch.logit_payload_slices(cfg, serve.max_batch,
                                                     serve.comm)
            per_step = n_slices if aggregate == "slice" else min(
                len(group.loops[0].channels), n_slices)
            n_tok = sum(len(r.tokens) for r in results)
            print(f"[serve-ring] hadronio {aggregate}/{flush} over a ring "
                  f"of {ring.world_size} (4 channels, 2 loops): "
                  f"{n_tok} tokens in {dt:.3f}s = {n_tok / dt:.1f} tok/s | "
                  f"prefill calls {prefills}, decode steps {decodes}, "
                  f"collectives {counts} ({counts['all_reduce'] / decodes:g}"
                  f" all-reduces per decode step, logit_payload_slices "
                  f"{n_slices}), flash launches {launches} | {smi}")
            assert [tuple(r.tokens.tolist()) for r in results] == \
                want_tokens, "hadronio-served tokens differ from gspmd's"
            assert counts["all_reduce"] == per_step * decodes, \
                (counts, per_step, decodes)
            assert counts["all_gather_into_tensor"] >= prefills, counts
            assert launches == cfg.num_layers * prefills, \
                (launches, prefills)
            del group

        # prefill B=2 S=1024 and decode B=2 of every mode: wall time on
        # the host clock, and device time from the profiler. A step of
        # ~2,000 launches cannot be timed queued behind a device spin:
        # the launch queue fills and blocks the host before the spin ends.
        # gspmd at ring size 1 with no affinity is the pure local path
        # (no wire at all)
        for slice_bytes in (4 * 1024 * 1024, 256 * 1024):
            for mode in ("gspmd", "sockets", "vma", "hadronio"):
                comm = CommConfig(mode=mode, channels=4,
                                  slice_bytes=slice_bytes)
                step = dispatch.make_serve_step(cfg, comm, ring=ring)
                parts = []
                for what, fn in (
                        ("prefill B=2 S=1024",
                         lambda: step.prefill(params, big)),
                        ("decode step B=2",
                         lambda: step.decode(params, cache, dec))):
                    count.reset()
                    fn()
                    torch.cuda.synchronize()
                    calls = sum(count.counts.values())
                    wall = time_ms(fn, iters=3, warmup=1)
                    busy, n_k, ranked, by_name = profile_device(fn, top=8)
                    if busy is None:
                        parts.append(f"{what} {wall:.3f} ms wall, device "
                                     f"not measured ({calls} collectives)")
                        continue
                    nccl = sum(ms for name, ms in by_name.items()
                               if "nccl" in name.lower())
                    parts.append(f"{what} {wall:.3f} ms wall, {busy:.3f} ms "
                                 f"device ({n_k} kernels, nccl {nccl:.3f} "
                                 f"ms, {calls} collectives)")
                    if mode == "hadronio" and what.startswith("prefill") \
                            and slice_bytes == 4 * 1024 * 1024:
                        print("[profile] hadronio prefill (4 MiB slices) "
                              "top: " + "; ".join(
                                  f"{name[:60]} {ms:.3f}"
                                  for name, ms in ranked))
                print(f"[serve-ring-time] {mode} slice_bytes "
                      f"{slice_bytes >> 10} KiB: " + " | ".join(parts)
                      + f" | {smi}")
    finally:
        count.restore()
    return flash


def right_padded(reqs, dev) -> dict:
    """The engine's prefill batch of ``reqs``: prompts right-padded to
    the longest, with ``last_pos``."""
    lens = np.array([len(r.prompt) for r in reqs])
    toks = np.zeros((len(reqs), lens.max()), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :lens[i]] = r.prompt
    return {"tokens": torch.as_tensor(toks, device=dev),
            "last_pos": torch.as_tensor(lens - 1, device=dev)}


def step_times(smi, label, step, params, big, dec, cache) -> None:
    """Prefill (``big``) and decode (``dec`` against ``cache``) of a
    serve step: wall time on the host clock (a step of thousands of
    launches cannot be queued behind a device spin) and device time from
    the profiler, with its kernel count, busy share and NCCL share."""
    for what, fn in (("prefill", lambda: step.prefill(params, big)),
                     ("decode", lambda: step.decode(params, cache, dec))):
        wall = time_ms(fn, iters=3 if what == "prefill" else 10, warmup=1)
        busy, n_k, ranked, by_name = profile_device(fn)
        if busy is None:
            print(f"[profile] {label} {what}: {wall:.3f} ms wall, device "
                  f"time not measured (no device events) | {smi}")
            continue
        nccl = sum(ms for name, ms in by_name.items()
                   if "nccl" in name.lower())
        print(f"[profile] {label} {what}: {wall:.3f} ms wall, {busy:.3f} ms "
              f"device ({n_k} kernels, {busy / wall:.1%} busy, nccl "
              f"{nccl:.3f} ms); top: " + "; ".join(
                  f"{name[:48]} {ms:.3f}" for name, ms in ranked)
              + f" | {smi}")
        if what == "prefill":
            check_prefill_flash(label, by_name)


def moe_stage_times(smi, gen, cfg, params) -> None:
    """One moe layer's device time at the prefill (B=2, S=1024) and
    decode (B=2, S=1) shapes: the whole block (routing, dispatch, the
    expert GEMMs, combine) against the expert GEMMs alone on a buffer of
    the dispatched shape, and the f32 expert stage the expert-parallel
    path runs (its weight casts included)."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    p = tree_map(lambda t: t[0], params["layers"]["moe"])
    dev, e, d = gen.device, cfg.moe.num_experts, cfg.d_model
    for label, s in (("prefill B=2 S=1024", 1024), ("decode B=2", 1)):
        x = torch.randn((2, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        c = moe.capacity(s, cfg)
        buf = torch.randn((2, e, c, d), generator=gen, device=dev).to(
            torch.bfloat16)
        block = time_ms(lambda: moe.apply_moe(p, x, cfg), iters=10,
                        queued=True, label=f"{cfg.name} moe block")
        gemms = time_ms(lambda: moe.apply_experts(p, buf, cfg), iters=10,
                        queued=True, label=f"{cfg.name} expert GEMMs")
        f32 = time_ms(lambda: moe.apply_experts(
            {w: p[w].float() for w in ("wi", "wg", "wo")}, buf.float(),
            cfg), iters=3, queued=True, label=f"{cfg.name} f32 experts")
        print(f"[moe-time] {cfg.name} one layer, {label} (capacity {c}): "
              f"block {block:.4f} ms, expert GEMMs {gemms:.4f} ms, routing "
              f"+ dispatch + combine {block - gemms:.4f} ms; the f32 expert "
              f"stage of the exchange path {f32:.4f} ms | {smi}")
        del x, buf


def serve_decoder(gen, smi, arch, ring, *, num_layers=None, lens=None,
                  max_len=2048) -> int:
    """Phase 7 for one decoder-only model at full width (``num_layers``
    cuts the depth), bf16, random weights from the card's generator.
    ``lens``: prompt lengths of 8 requests served through the
    event-loop group (2 loops, 2 slots each, ``gspmd`` at ring size 1),
    or None for one prefill (B=2, S=1024) and 16 decode steps through
    the serve step. Checks token counts, one flash launch per layer per
    prefill call, first tokens replayed from the kernel path's logits,
    the first layer's attention output on the served batch (kernel vs
    plain, phase 3's row bound);
    for dense models the bf16 kernel path's logits against the same
    weights in f32 (as phase 4); for moe models the longest pair again
    through ``hadronio`` over ``ring`` (the expert exchange), its
    ``all_to_all_single`` count, its distance from the local path, and
    at f32 and 2 layers the exchange path bitwise equal to the local
    one. Times prefill and decode, wall and device. Returns the flash
    launches of the served runs."""
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import api
    from repro_torch.models.attention import attend_chunked
    from repro_torch.models.common import tree_map
    from repro_torch.serving import Request, dispatch, make_engine_group
    dev = gen.device
    cfg = get_config(arch)
    depth = cfg.num_layers
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    is_moe = cfg.family == "moe"
    release_memory(f"before {cfg.name}")
    t0 = time.perf_counter()
    params = api.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[init] {cfg.name}: {cfg.num_layers} of {depth} layers, "
          f"{cfg.param_count() / 1e9:.3f}B params ("
          f"{cfg.active_param_count() / 1e9:.3f}B active) {cfg.param_dtype}"
          f" in {time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    local = dispatch.make_serve_step(cfg, CommConfig(mode="gspmd",
                                                     channels=4))
    rng = np.random.default_rng(0)
    L = cfg.num_layers
    flash = 0
    if lens is not None:
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                        max_new=16) for i, n in enumerate(lens)]
        group = make_engine_group(cfg, params, ServeConfig(
            event_loops=2, poll="busy", max_batch=2, max_len=max_len,
            comm=CommConfig(mode="gspmd", channels=4)), seed=0, device=dev)
        ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        group.submit(reqs)
        results = sorted(group.run(threads=True), key=lambda r: r.uid)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.flash_attention.launches
        engines = [l.engine for l in group.loops]
        prefills = sum(e.prefills for e in engines)
        n_tok = sum(len(r.tokens) for r in results)
        print(f"[serve] {cfg.name}: {len(results)} requests (prompts "
              f"{list(lens)}), {n_tok} tokens in {dt:.3f}s = "
              f"{n_tok / dt:.1f} tok/s | prefill calls {prefills} "
              f"(admission rounds {sum(e.admit_prefills for e in engines)})"
              f", decode steps {sum(e.decode_steps for e in engines)}, "
              f"flash launches {launches} | {smi}")
        assert [r.uid for r in results] == list(range(len(reqs)))
        assert all(len(r.tokens) == 16 for r in results), \
            [len(r.tokens) for r in results]
        assert all(0 <= t < cfg.vocab_size for r in results
                   for t in r.tokens)
        assert launches == L * prefills, (launches, prefills)
        flash += launches
        del group, engines          # the engines hold the params
        # loop 0's first wave (uids 0 and 2) replays its first tokens
        pair = [reqs[0], reqs[2]]
        batch = right_padded(pair, dev)
        lk, _ = local.prefill(params, batch)
        first = lk.argmax(-1).tolist()
        assert first == [int(results[0].tokens[0]),
                         int(results[2].tokens[0])], \
            (first, results[0].tokens[:1], results[2].tokens[:1])
    else:
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (2, 1024)), device=dev)}
        ops.flash_attention.launches = 0
        lk, cache = local.prefill(params, batch)
        launches = ops.flash_attention.launches
        cache = api.grow_cache(cfg, cache, max_len)
        tok, pos = lk.argmax(-1), torch.full((2,), 1024, device=dev)
        for _ in range(16):
            logits, cache = local.decode(params, cache,
                                         {"token": tok, "pos": pos})
            tok, pos = logits.argmax(-1), pos + 1
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all())
        print(f"[serve] {cfg.name}: one prefill (B=2, S=1024) and 16 decode "
              f"steps through the serve step, flash launches {launches} | "
              f"{smi}")
        assert launches == L, launches
        flash += launches
        del cache, logits
    assert lk.shape == (2, cfg.vocab_size) and bool(torch.isfinite(lk).all())

    # prefill B=2 S=1024 and decode B=2, wall and device
    big = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                  (2, 1024)), device=dev)}
    _, cache = local.prefill(params, big)
    cache = api.grow_cache(cfg, cache, max_len)
    dec = {"token": torch.zeros(2, dtype=torch.long, device=dev),
           "pos": torch.tensor([1024, 1024], device=dev)}
    step_times(smi, cfg.name, local, params, big, dec, cache)
    del cache
    torch.cuda.synchronize()
    print(f"[memory] {cfg.name}: peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
          f"({base_gb:.2f} GB before the run) | {smi}")

    def plain_prefill():
        """The served batch through the plain attention path: its
        logits; and the first layer's attention output, kernel against
        plain, held to phase 3's row bound on the q, k, v that layer
        was given."""
        seen = []

        def attend(q, k, v, **kw):
            if not seen:
                seen.append((q, k, v))
            return attend_chunked(q, k, v, **kw)

        lp, _ = api.prefill(params, batch, cfg, attend=attend)
        q, k, v = seen[0]
        w = cfg.sliding_window
        check_rows(f"{cfg.name} layer 0 attention on the served prompts "
                   f"{tuple(q.shape)} KV={k.shape[2]} window={w}: kernel "
                   f"vs plain", ops.flash_attention(q, k, v, window=w),
                   ref.flash_attention(q, k, v, window=w))
        return lp

    if not is_moe:
        # the kernel path against the plain attention path, ground truth
        # the same weights in f32 (phase 4's rule)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        lp = plain_prefill()
        p32 = tree_map(lambda t: t.float(), params)
        l32, _ = api.prefill(p32, batch, cfg32, attend=attend_chunked)
        lk32, _ = api.prefill(p32, batch, cfg32)
        del p32
        e32, ek, ep = rel_l2(lk32, l32), rel_l2(lk, l32), rel_l2(lp, l32)
        ok = e32 <= 1e-3 and ek <= 2 * ep + 5e-3
        print(f"[check] {cfg.name} prefill logits of "
              f"{tuple(batch['tokens'].shape)}: f32 kernel vs plain rel_l2="
              f"{e32:.3e} (bound 1e-3); bf16 vs f32 rel_l2 kernel={ek:.3e} "
              f"plain={ep:.3e} (bound 2x plain + 5e-3); bf16 kernel vs plain "
              f"max_abs_err={float((lk.float() - lp.float()).abs().max()):.3e}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{cfg.name}: prefill logits of the kernel "
                                 "path disagree with the plain path")
        del params, lk, lp, l32, lk32
        return flash

    moe_stage_times(smi, gen, cfg, params)
    # the longest pair through the expert exchange: hadronio over the ring
    comm = CommConfig(mode="hadronio", channels=4)
    wired = make_engine_group(cfg, params, ServeConfig(
        event_loops=1, poll="busy", max_batch=2, max_len=max_len,
        comm=comm), seed=0, device=dev, ring=ring)
    count = CollectiveCount()
    try:
        ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        wired.submit(pair)
        wres = sorted(wired.run(threads=False), key=lambda r: r.uid)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.flash_attention.launches
        counts = dict(count.counts)
    finally:
        count.restore()
    eng = wired.loops[0].engine
    s = len(pair[0].prompt)
    per_layer = 2 * (dispatch.expert_exchange_slices(cfg, 2, s, comm)
                     * eng.prefills + dispatch.expert_exchange_slices(
                         cfg, 2, 1, comm) * eng.decode_steps)
    same = sum(a == b for r, w in zip((results[0], results[2]), wres)
               for a, b in zip(r.tokens.tolist(), w.tokens.tolist()))
    print(f"[serve-ring] {cfg.name} hadronio over a ring of "
          f"{ring.world_size} (expert exchange, f32 experts): uids 0, 2 "
          f"(prompts {s}) in {dt:.3f}s, prefill calls {eng.prefills}, "
          f"decode steps {eng.decode_steps}, collectives {counts} "
          f"(all_to_all_single predicted {L} layers x {per_layer}), flash "
          f"launches {launches}; {same} of 32 tokens equal the local bf16 "
          f"path's | {smi}")
    assert all(len(r.tokens) == 16 for r in wres)
    assert counts["all_to_all_single"] == L * per_layer, counts
    assert launches == L * eng.prefills, (launches, eng.prefills)
    flash += launches
    del wired, eng
    ep_step = dispatch.make_serve_step(cfg, comm, ring=ring)
    le, _ = ep_step.prefill(params, batch)
    # yardstick: the local path with plain attention, the same bf16
    # weights (routing flips under bf16 rounding move moe logits by O(1))
    lp = plain_prefill()
    print(f"[check] {cfg.name} prefill logits of "
          f"{tuple(batch['tokens'].shape)}: the exchange path (f32 experts) "
          f"vs the local path (bf16 experts) rel_l2={rel_l2(le, lk):.3e}, "
          f"max_abs_err={float((le.float() - lk.float()).abs().max()):.3e},"
          f" argmax equal {le.argmax(-1).tolist() == lk.argmax(-1).tolist()}"
          " (reported, not bounded: the reference's exchange path computes"
          f" the experts in f32); the local path with plain attention vs "
          f"the kernel path rel_l2={rel_l2(lp, lk):.3e}")
    del lp
    _, cache = ep_step.prefill(params, big)
    cache = api.grow_cache(cfg, cache, max_len)
    step_times(smi, f"{cfg.name} hadronio (expert exchange)", ep_step,
               params, big, dec, cache)
    del cache, params, le, lk, ep_step, local

    # f32, full width, 2 layers: the exchange path bitwise equal to the
    # local path (prefill logits and cache, then a decode step), and the
    # kernel path against the plain attention path
    release_memory(f"before {cfg.name} f32 2 layers")
    cfg2 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    p2 = api.init(gen, cfg2, device=dev)
    local2 = dispatch.make_serve_step(cfg2, CommConfig(mode="gspmd"))
    ep2 = dispatch.make_serve_step(cfg2, comm, ring=ring)
    outs = []
    for step in (local2, ep2):
        lp_, c_ = step.prefill(p2, big)
        c_ = api.grow_cache(cfg2, c_, max_len)
        pre = (lp_, c_["k"].clone(), c_["v"].clone())
        ld_, _ = step.decode(p2, c_, dict(
            dec, token=outs[0][0].argmax(-1) if outs else lp_.argmax(-1)))
        outs.append(pre + (ld_,))
        del c_
    check_bitwise(f"{cfg.name} f32 2 layers: exchange path vs local path, "
                  "prefill logits, K, V and decode logits",
                  list(zip(outs[1], outs[0])))
    lp2, _ = api.prefill(p2, big, cfg2, attend=attend_chunked)
    e2 = rel_l2(outs[0][0], lp2)
    print(f"[check] {cfg.name} f32 2 layers, prefill logits of (2, 1024): "
          f"kernel vs plain rel_l2={e2:.3e} (bound 1e-3) "
          f"{'ok' if e2 <= 1e-3 else 'FAIL'}")
    if not e2 <= 1e-3:
        raise AssertionError(f"{cfg.name}: kernel path disagrees with the "
                             "plain path")
    del p2, outs, lp2
    return flash


class FlashCalls:
    """Records (S, causal) of every ``ops.flash_attention`` call the
    models make, by replacing the module attribute they look up at call
    time with a recording wrapper. The wrapper counts the kernel's
    launches itself: ``ops`` adds each launch to whatever its module
    attribute ``flash_attention`` is at that moment. Thread-safe: the
    threaded event loops record together."""

    def __init__(self):
        import threading
        from repro_torch.kernels import ops
        self.ops, self.real = ops, ops.flash_attention
        self.lock = threading.Lock()
        self.calls: list = []

        def recorded(q, k, v, *, causal=True, window=0):
            with self.lock:
                self.calls.append((q.shape[1], causal))
            return self.real(q, k, v, causal=causal, window=window)
        recorded.launches = 0
        self.wrapper = ops.flash_attention = recorded

    def reset(self) -> None:
        with self.lock:
            self.calls = []
            self.wrapper.launches = 0

    def check(self, cfg, prefills: int) -> dict:
        """Per prefill call: one non-causal launch per encoder layer at
        S = num_frames (encdec) and one causal launch per decoder layer,
        every call a launch. Returns {"non-causal", "causal",
        "launches"}."""
        with self.lock:
            calls, launches = list(self.calls), self.wrapper.launches
        enc = [s for s, causal in calls if not causal]
        dec = [s for s, causal in calls if causal]
        got = {"non-causal": len(enc), "causal": len(dec),
               "launches": launches}
        assert got == {"non-causal": cfg.encoder_layers * prefills,
                       "causal": cfg.num_layers * prefills,
                       "launches": len(calls)}, (got, prefills)
        assert all(s == cfg.num_frames for s in enc), enc
        assert all(s > cfg.num_patches for s in dec), dec
        return got

    def restore(self) -> None:
        self.ops.flash_attention = self.real


def serve_encdec_vlm(gen, smi, arch, ring, lens, *, check_layers=None,
                     max_len=2048) -> int:
    """Phase 8 for one model at full width, bf16, random weights from the
    card's generator: 8 requests (prompt lengths ``lens``, 16 new tokens,
    greedy) through the event-loop group (2 loops, 2 slots each,
    ``gspmd`` at ring size 1), the stub frontend's zero frames or patches
    fed by the engine. Checks token counts; per prefill call one
    non-causal flash launch per encoder layer at S = num_frames and one
    causal launch per decoder layer; first tokens replayed from the
    kernel path's logits; the first layer's bf16 attention on the served
    batch within phase 3's row bound; phase 4's logit rule (at
    ``check_layers`` of the layers, default all): f32 kernel vs plain
    within 1e-3 rel_l2, bf16 kernel vs f32 no farther than twice the bf16
    plain path plus 5e-3; the longest pair again through ``hadronio``
    over ``ring`` with the same tokens. Times prefill (B=2, 1024 tokens)
    and decode (B=2), wall and device, and reports peak memory. Returns
    the flash launches of the served runs."""
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import api
    from repro_torch.models.attention import attend_chunked
    from repro_torch.models.common import tree_map
    from repro_torch.serving import Request, dispatch, make_engine_group
    dev = gen.device
    cfg = get_config(arch)
    release_memory(f"before {cfg.name}")
    t0 = time.perf_counter()
    params = api.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    stub = (f"{cfg.num_frames} frames" if cfg.family == "encdec"
            else f"{cfg.num_patches} patches")
    print(f"[init] {cfg.name}: {cfg.family}, {cfg.encoder_layers} encoder "
          f"+ {cfg.num_layers} decoder layers, {stub}, "
          f"{cfg.param_count() / 1e9:.3f}B params {cfg.param_dtype} in "
          f"{time.perf_counter() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    local = dispatch.make_serve_step(cfg, CommConfig(mode="gspmd",
                                                     channels=4))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=16) for i, n in enumerate(lens)]
    pair = [reqs[0], reqs[2]]         # loop 0's first wave
    flash = FlashCalls()
    try:
        group = make_engine_group(cfg, params, ServeConfig(
            event_loops=2, poll="busy", max_batch=2, max_len=max_len,
            comm=CommConfig(mode="gspmd", channels=4)), seed=0, device=dev)
        flash.reset()
        t0 = time.perf_counter()
        group.submit(reqs)
        results = sorted(group.run(threads=True), key=lambda r: r.uid)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        engines = [l.engine for l in group.loops]
        prefills = sum(e.prefills for e in engines)
        got = flash.check(cfg, prefills)
        st = group.poll_stats()
        n_tok = sum(len(r.tokens) for r in results)
        print(f"[serve] {cfg.name}: {len(results)} requests (prompts "
              f"{list(lens)}), {n_tok} tokens in {dt:.3f}s = "
              f"{n_tok / dt:.1f} tok/s | prefill calls {prefills} "
              f"(admission rounds {sum(e.admit_prefills for e in engines)})"
              f", decode steps {sum(e.decode_steps for e in engines)}, "
              f"flash {got} | poll spins={st.spins} parks={st.parks} | "
              f"{smi}")
        assert [r.uid for r in results] == list(range(len(reqs)))
        assert all(len(r.tokens) == 16 for r in results), \
            [len(r.tokens) for r in results]
        assert all(0 <= t < cfg.vocab_size for r in results
                   for t in r.tokens)
        launches = got["launches"]
        del group, engines          # the engines hold the params

        # the same pair through the sliced hadronio wire over the ring
        wired = make_engine_group(cfg, params, ServeConfig(
            event_loops=1, poll="busy", max_batch=2, max_len=max_len,
            comm=CommConfig(mode="hadronio", channels=4)), seed=0,
            device=dev, ring=ring)
        flash.reset()
        t0 = time.perf_counter()
        wired.submit(pair)
        wres = sorted(wired.run(threads=False), key=lambda r: r.uid)
        torch.cuda.synchronize()
        dt_w = time.perf_counter() - t0
        eng = wired.loops[0].engine
        got_w = flash.check(cfg, eng.prefills)
        print(f"[serve-ring] {cfg.name} hadronio over a ring of "
              f"{ring.world_size}: uids 0, 2 (prompts "
              f"{[len(r.prompt) for r in pair]}) in {dt_w:.3f}s, prefill "
              f"calls {eng.prefills}, decode steps {eng.decode_steps}, "
              f"flash {got_w} | {smi}")
        assert [r.tokens.tolist() for r in wres] == \
            [results[0].tokens.tolist(), results[2].tokens.tolist()], \
            "hadronio-served tokens differ from gspmd's"
        launches += got_w["launches"]
        del wired, eng
    finally:
        flash.restore()

    # loop 0's first wave replays its served first tokens from the
    # kernel path's prefill logits (the reference's first-token rows)
    batch = dict(right_padded(pair, dev), **api.stub_inputs(cfg, 2, dev))
    lk, _ = local.prefill(params, batch)
    first = lk.argmax(-1).tolist()
    assert first == [int(results[0].tokens[0]), int(results[2].tokens[0])], \
        (first, results[0].tokens[:1], results[2].tokens[:1])
    assert lk.shape == (2, cfg.vocab_size) and bool(torch.isfinite(lk).all())
    print(f"[check] {cfg.name} first tokens {first} replayed from the "
          f"kernel path's prefill logits (max |logit| "
          f"{float(lk.float().abs().max()):.3e}) | {smi}")

    # prefill B=2, 1024 tokens (plus the frames or patches) and decode B=2
    big = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                  (2, 1024)), device=dev),
           **api.stub_inputs(cfg, 2, dev)}
    _, cache = local.prefill(params, big)
    cache = api.grow_cache(cfg, cache, max_len)
    dec = {"token": torch.zeros(2, dtype=torch.long, device=dev),
           "pos": torch.tensor([1024, 1024], device=dev)}
    step_times(smi, cfg.name, local, params, big, dec, cache)
    del cache
    torch.cuda.synchronize()
    print(f"[memory] {cfg.name}: peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
          f"({base_gb:.2f} GB before the run) | {smi}")

    # phase 4's logit rule on the served batch, at ``check_layers`` of
    # the layers; the first layer's attention (whisper: the encoder's,
    # non-causal) held to phase 3's row bound, kernel vs plain. llava's
    # served rows are patch rows (the reference's quirk), and with the
    # stub's zero patches every such row is exactly zero through every
    # layer, so its logits are zero: the check takes random patch
    # embeddings and reads each prompt's last token instead
    cfg_c, p_c = cfg, params
    if cfg.family == "vlm":
        batch = dict(batch, last_pos=batch["last_pos"] + cfg.num_patches,
                     patches=torch.randn(batch["patches"].shape,
                                         generator=gen, device=dev).to(
                         batch["patches"].dtype))
    if check_layers:
        cfg_c = dataclasses.replace(cfg, num_layers=check_layers)
        p_c = dict(params, layers=tree_map(lambda t: t[:check_layers],
                                           params["layers"]))
    lk, _ = api.prefill(p_c, batch, cfg_c)
    seen = []

    def attend(q, k, v, **kw):
        if not seen:
            seen.append((q, k, v, kw))
        return attend_chunked(q, k, v, **kw)

    lp, _ = api.prefill(p_c, batch, cfg_c, attend=attend)
    q, k, v, kw = seen[0]
    check_rows(f"{cfg.name} layer 0 attention on the served prompts "
               f"{tuple(q.shape)} KV={k.shape[2]} {kw}: kernel vs plain",
               ops.flash_attention(q, k, v, **kw),
               ref.flash_attention(q, k, v, **kw))
    del seen, q, k, v
    cfg32 = dataclasses.replace(cfg_c, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), p_c)
    l32, _ = api.prefill(p32, batch, cfg32, attend=attend_chunked)
    lk32, _ = api.prefill(p32, batch, cfg32)
    del p32, p_c
    e32, ek, ep = rel_l2(lk32, l32), rel_l2(lk, l32), rel_l2(lp, l32)
    ok = e32 <= 1e-3 and ek <= 2 * ep + 5e-3
    print(f"[check] {cfg.name} ({cfg_c.num_layers} of {cfg.num_layers} "
          f"decoder layers) prefill logits of "
          f"{tuple(batch['tokens'].shape)}"
          f"{' (random patches)' if cfg.family == 'vlm' else ''}: f32 "
          f"kernel vs plain rel_l2="
          f"{e32:.3e} (bound 1e-3); bf16 vs f32 rel_l2 kernel={ek:.3e} "
          f"plain={ep:.3e} (bound 2x plain + 5e-3); bf16 kernel vs plain "
          f"max_abs_err={float((lk.float() - lp.float()).abs().max()):.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{cfg.name}: prefill logits of the kernel "
                             "path disagree with the plain path")
    del params, lk, lp, l32, lk32, local
    return launches


# phase 5c: the rest of the hadronio family, each trained 5 steps
# (label, mode, aggregate, flush); all with compress=bf16, pack=pallas
FAMILY_RUNS = (
    ("hadronio_rs/bf16/pallas", "hadronio_rs", "slice", "step"),
    ("hadronio_overlap/bf16/pallas", "hadronio_overlap", "slice", "step"),
    ("hadronio_overlap_rs/bf16/pallas", "hadronio_overlap_rs", "slice",
     "step"),
    ("hadronio_overlap_rs/bf16/pallas channel/ready", "hadronio_overlap_rs",
     "channel", "ready"))


def family_launches_per_step(run) -> dict:
    """The ring-pack launches one step of ``run`` must make: the ZeRO-1
    ring mode packs and unpacks its stacked slices once; the overlap
    modes pack once per bucket and unpack once per flush (per bucket
    under ``aggregate=slice``, per channel under ``channel``)."""
    from repro_torch.core.backends import hadronio_overlap as ov
    from repro_torch.models import api
    comm = run.comm
    if comm.mode == "hadronio_rs":
        return {"pack_slices": 1, "unpack_slices": 1}
    n = ov.make_bucket_plan(api.specs(run.model), comm).n_buckets
    flushes = n if comm.aggregate == "slice" else min(comm.channels, n)
    return {"pack_slices": n, "unpack_slices": flushes}


def bucket_ef(ring_ef, tree, comm):
    """A ring-keyed error feedback (``(n_slices, S)``, the packed-flat
    layout) carried into the overlap modes' per-bucket layout, element
    for element (so every element's wire value is the same in both)."""
    from repro_torch.core import aggregation as agg
    from repro_torch.core.backends import hadronio_overlap as ov
    from repro_torch.models.common import tree_map, tree_paths
    f32 = tree_map(lambda t: t.float(), tree)
    ring_plan = agg.make_plan(f32, comm, dtype=torch.float32)
    leaves = [leaf for _, leaf in tree_paths(agg.unpack(
        ring_ef.reshape(-1), ring_plan, f32))]
    plan = ov.make_bucket_plan(f32, comm)
    return tuple(ov.pack_bucket(leaves, plan, b)
                 for b in range(plan.n_buckets))


def sync_family(cases, train_run, ring) -> None:
    """Phase 5c, the sync checks: each real full-width gradient case
    ``(what, grads, ring EF, hadronio's synced tree)`` through every new
    mode with ``pack=pallas`` and ``pack=jnp``: the pair bitwise equal
    (shard or tree, and the new EF); then each mode's gathered tree
    bitwise equal to hadronio's (at one peer a reduce-scatter is a
    copy)."""
    from repro_torch.core import tac
    from repro_torch.core.backends import get_backend
    from repro_torch.models.common import tree_paths
    pairs_of = lambda a, b: [(x, y) for (_, x), (_, y) in zip(
        tree_paths(a), tree_paths(b))]
    efs = lambda e: list(e) if isinstance(e, tuple) else [e]
    for what, tree, ring_ef, want in cases:
        for mode in ("hadronio_rs", "hadronio_overlap",
                     "hadronio_overlap_rs"):
            backend = get_backend(mode)
            res = {}
            for pack in ("pallas", "jnp"):
                comm = train_run(mode, compress="bf16", pack=pack).comm
                ef = ring_ef if mode == "hadronio_rs" else \
                    bucket_ef(ring_ef, tree, comm)
                res[pack] = tac.sync_grads(tree, comm, ring=ring, ef=ef)
                del ef
            torch.cuda.synchronize()
            a, b = res["pallas"], res["jnp"]
            pairs = [(a.flat_shard, b.flat_shard)] if backend.zero1 \
                else pairs_of(a.grads, b.grads)
            check_bitwise(f"real-gradient sync {mode} pallas vs jnp ({what};"
                          f" {'shard' if backend.zero1 else 'grads'}, new "
                          "EF)", pairs + list(zip(efs(a.ef), efs(b.ef))))
            check_bitwise(f"real-gradient sync {mode} gathered_grads vs "
                          f"hadronio's tree ({what})",
                          pairs_of(backend.gathered_grads(a, tree), want))
            del res, a, b, pairs


def train_family(smi, cfg, train_run, start, dev) -> dict:
    """Phase 5c, training: qwen2-0.5b at full width, 5 steps, through
    each of ``FAMILY_RUNS`` from ``start``'s params, on the Trainers'
    one-peer NCCL ring. Checks finite, falling losses, the pack and
    unpack launches per step (``family_launches_per_step``) and no
    flash launch; reports the peak memory and its rise over what was
    allocated before the run. Returns ``{label: (trainer, launches,
    peak GB)}``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import Trainer
    out = {}
    for label, mode, aggregate, flush in FAMILY_RUNS:
        run = train_run(mode, compress="bf16", pack="pallas",
                        aggregate=aggregate, flush=flush)
        trainer = Trainer(run, device=dev, log_every=10)
        # the step-0 state is live before the run, as hadronio's was;
        # the run holds the only reference, so it goes after step 1
        states = [steps_mod.tac_state(start.params, run)]
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        for wrapper in (ops.pack_slices, ops.unpack_slices,
                        ops.flash_attention):
            wrapper.launches = 0
        o = trainer.run_loop(states.pop())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {w.__name__: w.launches for w in (
            ops.pack_slices, ops.unpack_slices, ops.flash_attention)}
        per_step = family_launches_per_step(run)
        losses = o["losses"]
        mu = o["state"].opt.mu
        moments = f"flat shard {tuple(mu.shape)}" if torch.is_tensor(mu) \
            else "tree"
        print(f"[train] {cfg.name} {label}: losses "
              f"{[round(x, 4) for x in losses]}, step s "
              f"{[round(x, 4) for x in o['step_s']]}, launches {launches} "
              f"(per step {per_step}), moments {moments}, peak memory "
              f"{peak:.2f} GB ({peak - live:.2f} GB above the {live:.2f} GB "
              f"live before the run) | {smi}")
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], \
            (label, losses)
        assert launches == {k: 5 * v for k, v in per_step.items()} | {
            "flash_attention": 0}, (label, launches, per_step)
        assert o["state"].step == 5, label
        out[label] = (trainer, launches, peak)
        del o, mu
        torch.cuda.empty_cache()
    return out


def bucket_shape_times(smi, gen, dev, sizes) -> dict:
    """Ring pack (with EF, bf16 wire) and unpack at the overlap modes'
    bucket shapes ``(1, n)``: bitwise against the plain version, then
    kernel and plain times (queued) beside the bytes bound (pack 14 B
    and unpack 6 B per element). Returns ``{kernel: {n: times}}``."""
    from repro_torch.kernels import ops, ref
    out = {"pack_slices": {}, "unpack_slices": {}}
    for n in sizes:
        flat = torch.randn(n, generator=gen, device=dev) * 1e-3
        ef = torch.randn((1, n), generator=gen, device=dev) * 1e-6
        kw = dict(n_slices=1, slice_elems=n, wire_dtype="bfloat16")
        wire, new_ef = ops.pack_slices(flat, ef, **kw)
        un = ops.unpack_slices(wire)
        torch.cuda.synchronize()
        rw, re_ = ref.pack_slices(flat, ef, **kw)
        check_bitwise(f"ring_pack (1, {n}) bfloat16 ef (bucket shape)",
                      [(wire, rw), (new_ef, re_),
                       (un, ref.unpack_slices(rw))])
        iters = 200 if n < 1 << 20 else 10
        for name, kernel, plain, per_elem in (
                ("pack_slices", lambda: ops.pack_slices(flat, ef, **kw),
                 lambda: ref.pack_slices(flat, ef, **kw), 14.0),
                ("unpack_slices", lambda: ops.unpack_slices(wire),
                 lambda: ref.unpack_slices(wire), 6.0)):
            t = {"ms": time_ms(kernel, iters=iters, queued=True,
                               label=f"{name} (1, {n})"),
                 "plain_ms": time_ms(plain, iters=iters, queued=True,
                                     label=f"{name} plain (1, {n})"),
                 "bound_ms": per_elem * n / H100_BYTES_S * 1e3}
            out[name][n] = t
            print(f"[time] ring {name} bucket (1, {n}): kernel "
                  f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, bound "
                  f"{t['bound_ms']:.3e} ms (bytes; {t['bound_ms'] / t['ms']:.1%}"
                  f" of the HBM rate) | {smi}")
        del flat, ef, wire, new_ef, un, rw, re_
    torch.cuda.empty_cache()
    return out


# phase 5d: the fault-tolerant trainer (microbatches, checkpoints, restart)
FAULT_ENV = ("REPRO_FAULT_AT_STEP", "REPRO_FAULT_FLAG")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def write_token_shard(path: str, n_tokens: int, vocab: int) -> None:
    """One uint16 token shard with its ``.meta`` sidecar, from a numpy
    generator (seed 0): zipfian ids below ``vocab`` and 65536, so a model
    learns."""
    os.makedirs(path)
    rng = np.random.default_rng(0)
    ids = (rng.zipf(1.5, n_tokens) - 1) % min(vocab, 65536)
    ids.astype(np.uint16).tofile(
        os.path.join(path, "shard_0.bin"))
    with open(os.path.join(path, "shard_0.meta"), "w") as f:
        f.write("uint16")


def checkpoint_root(need_bytes: float) -> str:
    """The temporary directory's parent: TMPDIR or the checkout's
    ``build/``, whichever has more room. Prints its ``df``; raises when
    it has less than ``need_bytes`` free."""
    import shutil
    import tempfile
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = max((tempfile.gettempdir(), build),
               key=lambda d: shutil.disk_usage(d).free)
    print(subprocess.run(["df", "-h", root], capture_output=True,
                         text=True).stdout.rstrip())
    free = shutil.disk_usage(root).free
    print(f"[ckpt] temporary directory under {root}: {free / 1e9:.1f} GB "
          f"free, {need_bytes / 1e9:.1f} GB needed")
    if free < need_bytes:
        raise RuntimeError(f"{root} has {free / 1e9:.1f} GB free, less than "
                           f"three checkpoints ({need_bytes / 1e9:.1f} GB)")
    return root


def release_memory(label: str) -> None:
    """Collect the garbage, give PyTorch's cached blocks back to the card
    and print what is left: NCCL allocates a new communicator's buffers
    outside PyTorch's allocator, at the communicator's first collective,
    and fails when the cache holds the whole card. Phases 5 and 5d call
    it before each new ring's first step."""
    held = torch.cuda.mem_get_info()[0]
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[memory] {label}: allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, reserved "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB (peak "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB), free on the "
          f"card {free / 1e9:.2f} of {total / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB before the cache was emptied)")


def state_pairs(g, w) -> list:
    """The tensor leaves of two train states' ``leaf_files`` lists,
    paired by checkpoint file name; the ints (step, Adam count) must be
    equal."""
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        if not torch.is_tensor(b):
            assert a == b, (name, a, b)
    return [(a, b) for (_, a), (_, b) in zip(g, w) if torch.is_tensor(b)]


def train_fault_tolerant(smi, cfg, train_run, dev) -> dict:
    """Phase 5d: the fault-tolerant trainer at full width on the one-peer
    NCCL ring, hadronio/bf16/pallas, B=4, S=1024, seed 0, data from a
    token shard (``--data``): (a) write the shard; (b) 3 steps at
    ``microbatches`` 1 and 2 from one start state, with their launches
    and peak memory; (c) the main path, ``train_with_restarts`` with
    checkpoints every 2 steps and a fault injected at step 3, against an
    uninterrupted run; (d) a ``hadronio_rs`` state saved and restored at
    ring size 1; (e) checkpoint bytes, save and restore seconds, and the
    step time with an asynchronous save in flight. Returns the ring
    kernels' launches and (c)'s checkpoint directory, which phase 9
    serves; the temporary directory is removed when the script exits,
    whatever happened."""
    import atexit
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointStore, leaf_files
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import Trainer, train_with_restarts
    from repro_torch.models.common import tree_paths
    wrappers = (ops.pack_slices, ops.unpack_slices, ops.flash_attention)

    def reset():
        for w in wrappers:
            w.launches = 0

    def launches():
        return {w.__name__: w.launches for w in wrappers}

    total = {"pack_slices": 0, "unpack_slices": 0}
    release_memory("before phase 5d")

    def count(got, n_steps, label):
        assert got == {"pack_slices": n_steps, "unpack_slices": n_steps,
                       "flash_attention": 0}, (label, got)
        for k in total:
            total[k] += got[k]

    # bf16 params, f32 moments, f32 error feedback (padded slices)
    ckpt_bytes = cfg.param_count() * (2 + 4 + 4 + 4)
    tmp = tempfile.mkdtemp(prefix="ckpt-smoke-",
                           dir=checkpoint_root(3 * ckpt_bytes))
    # phase 9 serves 5d.c's checkpoint: the directory goes at exit
    atexit.register(shutil.rmtree, tmp, True)
    env = {k: os.environ.get(k) for k in FAULT_ENV}
    try:
        # -- a. a token shard, read through --data
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_token_shard(data, 8 * 2 ** 20 + 4096, cfg.vocab_size)
        print(f"[ckpt] token shard: {8 * 2 ** 20 + 4096} uint16 tokens "
              f"written in {time.perf_counter() - t0:.2f} s")

        def ft_run(mb, **kw):
            return dataclasses.replace(
                train_run("hadronio", compress="bf16", pack="pallas"),
                microbatches=mb, data_path=data, **kw)

        # -- b. microbatches 1 and 2 from one start state
        peaks, mb_losses = {}, {}
        start = None
        for mb in (1, 2):
            t = Trainer(ft_run(mb, total_steps=3), device=dev, log_every=10)
            start = t.init_state() if start is None else start
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            reset()
            o = t.run_loop(start)
            torch.cuda.synchronize()
            got = launches()
            peaks[mb] = torch.cuda.max_memory_allocated() / 1e9
            mb_losses[mb] = o["losses"]
            print(f"[train-ft] {cfg.name} hadronio/bf16/pallas --data, "
                  f"microbatches={mb} (B=4 as {mb} x {4 // mb}): losses "
                  f"{[round(x, 4) for x in o['losses']]}, step s "
                  f"{[round(x, 4) for x in o['step_s']]}, launches {got}, "
                  f"peak memory {peaks[mb]:.2f} GB ({peaks[mb] - live:.2f} "
                  f"GB above the {live:.2f} GB live) | {smi}")
            assert all(np.isfinite(o["losses"])), o["losses"]
            assert o["losses"][-1] < o["losses"][0], o["losses"]
            count(got, 3, f"microbatches={mb}")
            t.close()
            del o, t
        print(f"[train-ft] peak memory microbatches 1 -> 2: {peaks[1]:.2f} "
              f"-> {peaks[2]:.2f} GB ({peaks[1] - peaks[2]:.2f} GB less); "
              "max |loss difference| "
              f"{max(abs(a - b) for a, b in zip(*mb_losses.values())):.3e}")
        assert peaks[2] < peaks[1], peaks
        del start
        release_memory("after 5d.b")

        # -- c. the main path: checkpoints every 2 steps, a fault at step
        # 3, a restart from LATEST (step 2), against an uninterrupted run
        ck = os.path.join(tmp, "ckpt")
        run = ft_run(2, total_steps=4, checkpoint_dir=ck,
                     checkpoint_every=2, keep_checkpoints=2,
                     async_checkpoint=True)
        os.environ["REPRO_FAULT_AT_STEP"] = "3"
        os.environ["REPRO_FAULT_FLAG"] = os.path.join(tmp, "fault_fired")
        saved, restored, made, lines, times = {}, [], [], [], {}

        class Probe(Trainer):
            """Keeps a device copy of the state saved at step 2 and each
            restored state; times the saves' snapshots and the restore."""

            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(len(made))
                save = self.store.save_async

                def spy(step, state, extra=None):
                    if step == 2:
                        saved[step] = [(n, x.clone() if torch.is_tensor(x)
                                        else x) for n, x in
                                       leaf_files(state)]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    save(step, state, extra)
                    times.setdefault("snapshot", []).append(
                        time.perf_counter() - t0)
                self.store.save_async = spy

            def restore_or_init(self):
                t0 = time.perf_counter()
                state = super().restore_or_init()
                torch.cuda.synchronize()
                if len(made) > 1:
                    times.setdefault("restore", []).append(
                        time.perf_counter() - t0)
                    restored.append(state)
                return state

        reset()
        t0 = time.perf_counter()
        out = train_with_restarts(
            lambda: Probe(run, device=dev, log_every=1, log_fn=lines.append),
            log_fn=lines.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        for k in FAULT_ENV:
            del os.environ[k]
        store = CheckpointStore(ck)
        step_bytes = dir_bytes(store.step_dir(4))
        print(f"[train-ft] main path: train_with_restarts, microbatches=2, "
              f"--ckpt every 2 (async, keep 2), fault at step 3: restarts "
              f"{out['restarts']}, losses after the restart "
              f"{[round(x, 4) for x in out['losses']]}, checkpoints "
              f"{store.available_steps()} (LATEST {store.latest_step()}), "
              f"launches {got} (3 steps before the fault, 2 after), "
              f"{wall:.2f} s in all; snapshot s "
              f"{[round(x, 3) for x in times['snapshot']]}, restore s "
              f"{[round(x, 3) for x in times['restore']]} | {smi}")
        for line in lines:
            if line.startswith(("[supervisor]", "[trainer] restoring")):
                print(f"[train-ft]   {line}")
        assert out["restarts"] == 1 and len(made) == 2, out["restarts"]
        assert store.available_steps() == [2, 4] and \
            store.latest_step() == 4
        count(got, 5, "main path")
        names = [n for n, _ in saved[2]]
        check_bitwise("restored step-2 state vs the live state saved at "
                      f"step 2 ({len(names)} leaves: params, mu, nu, EF)",
                      state_pairs(leaf_files(restored[0]), saved[2]))
        ef = dict(saved[2])[".ef.npy"]
        print(f"[train-ft]   max|EF| at step 2 {float(ef.abs().max()):.3e} "
              "(f32 accumulated grads: the bf16 wire leaves a residual)")
        del saved, restored, made, ef
        release_memory("after 5d.c's restarted run")

        clean = Trainer(ft_run(2, total_steps=4), device=dev, log_every=10)
        ref = clean.run_loop()
        d_loss = abs(out["final_loss"] - ref["final_loss"])
        diff = [p for (p, a), (_, b) in zip(
            tree_paths(out["state"].params), tree_paths(ref["state"].params))
            if not torch.equal(bits(a), bits(b))]
        print(f"[train-ft] uninterrupted run: losses "
              f"{[round(x, 4) for x in ref['losses']]}; final loss "
              f"{out['final_loss']:.6f} restarted vs {ref['final_loss']:.6f} "
              f"(|diff| {d_loss:.3e}, limit 1e-5); final params bitwise "
              f"equal: {not diff}" + (f" (differ: {diff})" if diff else ""))
        assert d_loss < 1e-5, d_loss
        del out
        release_memory("after 5d.c's uninterrupted run")

        # -- d. hadronio_rs (flat ZeRO-1 moment shards) at ring size 1
        rs_run = dataclasses.replace(
            train_run("hadronio_rs", compress="bf16", pack="pallas"),
            total_steps=1, data_path=data)
        t = Trainer(rs_run, device=dev, log_every=10)
        reset()
        state = t.run_loop()["state"]
        count(launches(), 1, "hadronio_rs")
        rs_store = CheckpointStore(os.path.join(tmp, "rs"), keep=1,
                                   group=dist.group.WORLD,
                                   rows=steps_mod.ring_rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs_store.save(1, state)
        save_s = time.perf_counter() - t0
        rs_bytes = dir_bytes(rs_store.step_dir(1))
        t0 = time.perf_counter()
        back, s = elastic.restore_elastic(rs_store, rs_run, t.ring,
                                          device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mu_shape = rs_store.manifest(1)["leaves"]
        mu_shape = [x["shape"] for x in mu_shape
                    if x["file"] == ".opt_.mu.npy"]
        assert s == 1 and mu_shape == [[1, state.opt.mu.numel()]], mu_shape
        check_bitwise(f"hadronio_rs state saved and restored at ring size 1 "
                      f"(flat moments {tuple(state.opt.mu.shape)}, stored "
                      f"{tuple(mu_shape[0])})",
                      state_pairs(leaf_files(back), leaf_files(state)))
        print(f"[ckpt] hadronio_rs checkpoint {rs_bytes / 1e9:.3f} GB: "
              f"blocking save {save_s:.2f} s ({rs_bytes / save_s / 1e9:.2f}"
              f" GB/s), restore {restore_s:.2f} s "
              f"({rs_bytes / restore_s / 1e9:.2f} GB/s) | {smi}")
        t.close()
        del state, back, t
        shutil.rmtree(os.path.join(tmp, "rs"))
        release_memory("after 5d.d")

        # -- e. the step time with an asynchronous save in flight
        state = ref.pop("state")
        batch = clean.batch(4)

        def timed_steps(n):
            out = []
            for _ in range(n):
                t0 = time.perf_counter()
                _, m = clean.step_fn(state, batch)
                float(m["loss"])
                out.append((time.perf_counter() - t0) * 1e3)
                del m
            return out

        e_store = CheckpointStore(os.path.join(tmp, "e"), keep=1,
                                  group=dist.group.WORLD,
                                  rows=steps_mod.ring_rows)
        before = timed_steps(4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_store.save_async(4, state)
        snap_s = time.perf_counter() - t0
        during = timed_steps(4)
        t0 = time.perf_counter()
        e_store.wait()
        left_s = time.perf_counter() - t0
        after = timed_steps(4)
        print(f"[ckpt] hadronio checkpoint {step_bytes / 1e9:.3f} GB "
              f"(params, mu, nu, EF); async save: snapshot {snap_s:.2f} s "
              f"(blocking), the write still ran {left_s:.2f} s after the 4 "
              f"steps below; step ms (microbatches=2) without a save "
              f"{[round(x, 1) for x in before]}, with the write in flight "
              f"{[round(x, 1) for x in during]}, after "
              f"{[round(x, 1) for x in after]} (median "
              f"{statistics.median(before + after):.1f} vs "
              f"{statistics.median(during):.1f}) | {smi}")
        clean.close()
        del state, clean, ref
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    return total, ck


# phase 9: (arch, layers kept, global batch, seq_len) — full width, cut
# depth; the recurrent families run a smaller B x S, since their plain
# scans keep a state per step for the backward
TRAIN_FAMILIES = (("mixtral-8x7b", 1, 4, 1024),
                  ("rwkv6-7b", 4, 2, 512),
                  ("recurrentgemma-9b", 3, 2, 512))
PARITY_ARCHS = ("mixtral-8x7b", "rwkv6-7b", "recurrentgemma-9b",
                "whisper-tiny", "llava-next-mistral-7b")
# the state bytes per parameter at the peak of a donated
# hadronio/bf16/pallas step, read off the code: bf16 params (2), f32
# moments (8) and EF (4) live throughout; through the exchange the local
# bf16 grads (2), the new EF (4), and two of the f32 packed vector, the
# bf16 wire, the f32 unpacked sum and the bf16 synced tree, at most 4 + 2
# (the packed vector goes once packed, the wire once unpacked). The
# update writes into the donated params and moments a chunk at a time,
# so it holds less: the state, the new EF and the synced tree (20).
STEP_BYTES_PER_PARAM = 2 + 8 + 4 + 2 + 4 + 4 + 2


def family_batch(cfg, b: int, s: int, seed: int, device) -> dict:
    """A train batch of ``cfg``'s family from a numpy seed: tokens and
    labels, plus frames (encdec) or patches (vlm) of N(0, 1) in f32."""
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
           for k in ("tokens", "labels")}
    extra = {"encdec": ("frames", cfg.num_frames),
             "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if extra:
        out[extra[0]] = torch.from_numpy(rng.standard_normal(
            (b, extra[1], cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in out.items()}


def loss_and_grads(params, batch, cfg):
    """``api.loss`` and its gradient tree, by autograd over fresh leaves
    that alias ``params``."""
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = api.loss(leaves, batch, cfg)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        tree_map(lambda t: t.grad, leaves)


def train_families(smi, dev) -> dict:
    """Phase 9a: each of ``TRAIN_FAMILIES`` at full width and cut depth,
    bf16, 3 steps through a donating ``Trainer`` (hadronio/bf16/pallas
    on the one-peer NCCL ring, synthetic data, seed 0). Checks finite losses,
    one pack and one unpack launch a step, and no flash, WKV6 or RG-LRU
    launch (train mode runs the plain attention and scans); reports the
    median step time, one profiled step (device time, kernels, busy
    share) and the peak memory over what was live before the run.
    Returns the ring kernels' launches."""
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer
    wrappers = (ops.pack_slices, ops.unpack_slices, ops.flash_attention,
                ops.wkv6, ops.rglru)
    total = {"pack_slices": 0, "unpack_slices": 0}
    for arch, layers, b, s in TRAIN_FAMILIES:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        run = RunConfig(model=cfg, shape=ShapeConfig("smoke", "train", s, b),
                        comm=CommConfig(mode="hadronio", channels=4,
                                        compress="bf16", pack="pallas"),
                        total_steps=3, warmup_steps=1, seed=0)
        n = cfg.param_count()
        release_memory(f"before training {arch}")
        print(f"[train-fam] {arch}: {layers} of {full.num_layers} layers, "
              f"vocabulary {cfg.vocab_size} rows, {n / 1e9:.3f} B params; "
              f"the step's peak state at {STEP_BYTES_PER_PARAM} B/param: "
              f"{n * STEP_BYTES_PER_PARAM / 1e9:.1f} GB")
        trainer = Trainer(run, device=dev, log_every=10, donate=True)
        # the run holds the only reference to the state it consumes
        states = [trainer.init_state()]
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers:
            w.launches = 0
        o = trainer.run_loop(states.pop())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = {w.__name__: w.launches for w in wrappers}
        step_ms = statistics.median(o["step_s"]) * 1e3
        print(f"[train-fam] {arch} ({layers} of {full.num_layers} layers, "
              f"B={b} S={s}) hadronio/bf16/pallas: losses "
              f"{[round(x, 4) for x in o['losses']]}, step ms "
              f"{[round(x * 1e3, 1) for x in o['step_s']]} (median "
              f"{step_ms:.1f}), launches {got} (per step: pack "
              f"{got['pack_slices'] / 3:g}, unpack "
              f"{got['unpack_slices'] / 3:g}), peak memory {peak:.2f} GB "
              f"({peak - live:.2f} GB above the {live:.2f} GB live before "
              f"the run; {peak * 1e9 / n:.1f} B/param) | {smi}")
        assert all(np.isfinite(o["losses"])), (arch, o["losses"])
        assert got == {"pack_slices": 3, "unpack_slices": 3,
                       "flash_attention": 0, "wkv6": 0, "rglru": 0}, \
            (arch, got)
        assert o["state"].step == 3, arch
        for k in total:
            total[k] += got[k]
        end = o.pop("state")
        batch = trainer.batch(3)
        busy, n_k, ranked, _ = profile_device(
            lambda: trainer.step_fn(end, batch), top=6)
        if busy is None:
            print(f"[profile] train step {arch}: device time not measured "
                  "(the profiler recorded no device events)")
        else:
            print(f"[profile] train step {arch}: {n_k} kernels, {busy:.3f} "
                  f"ms on the device of {step_ms:.3f} ms per step "
                  f"({busy / step_ms:.1%} busy); top: " + "; ".join(
                      f"{name[:90]} {ms:.3f}" for name, ms in ranked))
        trainer.close()
        del trainer, o, end, batch
    return total


def train_parity(smi, gen, dev) -> None:
    """Phase 9b: at each of ``PARITY_ARCHS``' ``-reduced`` configs (f32)
    the card's ``api.loss``, aux and every gradient leaf of one backward
    against the port's CPU run on the same params and batch, at the
    port's model tolerance (atol = rtol = 1e-4: the devices sum in other
    orders, TF32 is off); then whisper-tiny whole (bf16, 1500 frames, a
    448-token decoder batch of 2): finite loss and gradients, and no
    flash launch (the encoder's train mode takes the plain attention)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.common import tree_map, tree_paths
    from repro_torch.optim.adamw import global_norm
    for i, arch in enumerate(PARITY_ARCHS):
        cfg = get_config(arch + "-reduced")
        params = api.init(torch.Generator().manual_seed(i), cfg, device="cpu")
        batch = family_batch(cfg, 2, 64, i, "cpu")
        res = {}
        for d in ("cpu", dev):
            p = tree_map(lambda t: t.to(d), params)
            loss, aux, grads = loss_and_grads(
                p, {k: v.to(d) for k, v in batch.items()}, cfg)
            res[str(d)] = (loss.cpu(), {k: v.cpu() for k, v in aux.items()},
                           global_norm(grads).cpu(),
                           [(path, g.cpu()) for path, g in tree_paths(grads)])
        (lc, ac, gc_, lc_g), (lg, ag, gg, lg_g) = res["cpu"], res[str(dev)]
        check_close(f"{arch}-reduced loss, card vs CPU", lg, lc, 1e-4, 1e-4)
        assert sorted(ag) == sorted(ac), (ag, ac)
        for k in ac:
            check_close(f"{arch}-reduced aux {k}, card vs CPU", ag[k], ac[k],
                        1e-4, 1e-4, verbose=False)
        assert [path for path, _ in lg_g] == [path for path, _ in lc_g]
        worst = max((check_close(f"{arch}-reduced grad {path}, card vs CPU",
                                 g, want, 1e-4, 1e-4, verbose=False), path)
                    for (path, g), (_, want) in zip(lg_g, lc_g))
        print(f"[train-parity] {arch}-reduced: loss card {float(lg):.7f} "
              f"cpu {float(lc):.7f}, aux {({k: float(v) for k, v in ag.items()})}"
              f", grad norm card {float(gg):.7f} cpu {float(gc_):.7f}; "
              f"all {len(lg_g)} gradient leaves within atol = rtol = 1e-4, "
              f"largest |diff| {worst[0]:.3e} ({worst[1]})")
    cfg = get_config("whisper-tiny")
    params = api.init(gen, cfg, device=dev)
    batch = family_batch(cfg, 2, 448, 0, dev)
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [p for p, g in tree_paths(grads) if not bool(
        torch.isfinite(g).all())]
    print(f"[train-parity] whisper-tiny whole (frames (2, 1500, 384), 448 "
          f"tokens): loss {float(loss):.4f}, grad norm "
          f"{float(global_norm(grads)):.4f}, {wall:.2f} s for the first "
          f"loss and backward, flash launches "
          f"{ops.flash_attention.launches} | {smi}")
    assert bool(torch.isfinite(loss)) and not bad, (float(loss), bad)
    assert ops.flash_attention.launches == 0
    del params, grads


def serve_from_checkpoint(smi, ckpt, ring, dev) -> int:
    """Phase 9c: ``launch.serve --ckpt`` on qwen2-0.5b, pointed at phase
    5d's checkpoint directory: the params it restores equal the LATEST
    step's files bitwise (read here with numpy), it prints the restore
    line, and it serves 4 requests whose prefills run flash (24 layers a
    call). Their tokens equal those of an in-process engine group (the
    CLI's serve config, on ``ring``) on the same restored params, and
    a prefill of the first prompt gives finite logits. Returns the CLI
    run's flash launches."""
    import contextlib
    import io
    from repro_torch.checkpoint import CheckpointStore, leaf_files
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.steps import TrainState
    from repro_torch.models import api
    from repro_torch.serving import make_engine_group
    cfg = get_config("qwen2-0.5b")
    store = CheckpointStore(ckpt)
    step = store.latest_step()
    params = serve_cli.load_params(cfg, ckpt=ckpt, batch=2, max_len=2048,
                                   seed=0, device=dev)
    pairs = []
    for name, t in leaf_files(TrainState(params, None, step)):
        if not torch.is_tensor(t):
            continue
        arr = np.load(os.path.join(store.step_dir(step), name))
        want = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            if arr.dtype.kind == "V" else torch.from_numpy(arr)  # bf16 bits
        pairs.append((t.cpu(), want))
    check_bitwise(f"qwen2-0.5b params restored by launch.serve --ckpt vs "
                  f"step {step}'s files ({len(pairs)} leaves)", pairs)
    del pairs
    ops.flash_attention.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve_cli.main(["--arch", "qwen2-0.5b", "--ckpt", ckpt,
                             "--requests", "4", "--max-new", "8", "--batch",
                             "2", "--max-len", "2048", "--event-loops", "2",
                             "--device", dev.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    for line in out.getvalue().splitlines():
        print(f"[serve-ckpt]   {line}")
    print(f"[serve-ckpt] qwen2-0.5b --ckpt (phase 5d, LATEST {step}): rc {rc},"
          f" {wall:.2f} s, flash launches {launches} | {smi}")
    assert rc == 0 and f"[serve] restored params from step {step}" \
        in out.getvalue() and "[serve] 4 requests, 32 tokens" \
        in out.getvalue(), out.getvalue()
    assert launches and launches % cfg.num_layers == 0, launches
    # the same requests through an in-process group on the restored
    # params, with the CLI's defaults (gspmd, busy polling)
    served = {int(m[1]): [int(t) for t in m[2].split(",")] for m in
              re.finditer(r"uid=(\d+) prompt_len=\d+ -> \[([^\]]*)\]",
                          out.getvalue())}
    group = make_engine_group(cfg, params, ServeConfig(
        event_loops=2, poll="busy", max_batch=2, max_len=2048,
        comm=CommConfig(mode="gspmd", channels=4)), seed=0, device=dev,
        ring=ring)
    reqs = serve_cli.make_requests(cfg, 4, max_new=8, temperature=0.0,
                                   seed=0)
    group.submit(reqs)
    mine = {r.uid: r.tokens.tolist() for r in group.run(threads=True)}
    with torch.no_grad():
        logits, _ = api.prefill(params, {"tokens": torch.as_tensor(
            reqs[0].prompt, device=dev)[None]}, cfg)
    torch.cuda.synchronize()
    print(f"[serve-ckpt] tokens of the CLI {served}; of an in-process "
          f"group on the same params {mine}; prefill logits of request 0 "
          f"{tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}, top token "
          f"{int(logits[0].argmax())}")
    assert len(served) == 4 and served == mine, (served, mine)
    assert logits.shape == (1, cfg.vocab_size) and \
        bool(torch.isfinite(logits).all())
    del params, group, logits
    return launches


def serve_tenants(gen, smi) -> dict:
    """Phase 10a: two families side by side in ONE event-loop group:
    tenants ``chat`` (qwen2-0.5b, weight 2, one loop) and ``rnn``
    (rwkv6-7b, weight 1, one loop), whole, at full width, bf16, weights
    from the card's generator, ``gspmd``, busy polling, threaded drains.
    Six requests alternate between the tenants (qwen prompts of 64..1024
    tokens, rwkv prompts 512, 512 and 256), 8 new tokens each, greedy.
    Checks the dispatch log (the 2:1 stride sequence) and the fairness
    counters, that each tenant's tokens equal a single-tenant group's on
    the same params and requests, and that every qwen prefill launched
    flash (one per layer) and every rwkv prefill and decode step WKV6
    (one per layer). Then runs ``launch.serve --tenant`` with the same
    two models as a subprocess and checks its fairness line. Returns the
    group run's launches by wrapper."""
    from repro_torch.configs.base import (CommConfig, ServeConfig,
                                          TenantConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving import Request, make_engine_group
    dev = gen.device
    cfgs = {"chat": get_config("qwen2-0.5b"), "rnn": get_config("rwkv6-7b")}
    t0 = time.perf_counter()
    params = {n: api.init(gen, c, device=dev) for n, c in cfgs.items()}
    torch.cuda.synchronize()
    print(f"[init] tenants: " + ", ".join(
        f"{n}={c.name} {c.param_count() / 1e9:.3f}B {c.param_dtype}"
        for n, c in cfgs.items())
        + f" in {time.perf_counter() - t0:.2f}s")
    comm = CommConfig(mode="gspmd", channels=4)
    serve = ServeConfig(
        event_loops=2, poll="busy", max_batch=2, max_len=1536, comm=comm,
        tenants=(TenantConfig("chat", arch=cfgs["chat"].name, weight=2),
                 TenantConfig("rnn", arch=cfgs["rnn"].name, weight=1)))
    group = make_engine_group(cfgs, params, serve, seed=0, device=dev)
    rng = np.random.default_rng(0)
    rnn_lens = iter((512, 512, 256))
    reqs = []
    for uid in range(6):
        name = ("chat", "rnn")[uid % 2]
        n = int(rng.integers(64, 1025)) if name == "chat" else next(rnn_lens)
        reqs.append(Request(uid, rng.integers(0, cfgs[name].vocab_size, n),
                            max_new=8, tenant=name))
    wrappers = (ops.flash_attention, ops.wkv6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    group.submit(reqs)
    results = sorted(group.run(threads=True), key=lambda r: r.uid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {w.__name__: w.launches for w in wrappers}
    chat, rnn = (l.engine for l in group.loops)
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[tenants] chat={cfgs['chat'].name}:2 rnn={cfgs['rnn'].name}:1, "
          f"prompts {[len(r.prompt) for r in reqs]}: {n_tok} tokens in "
          f"{dt:.3f}s = {n_tok / dt:.1f} tok/s | dispatch "
          f"{list(group.dispatch_log)} fairness {group.fairness_counters} | "
          f"chat prefill calls {chat.prefills}, rnn prefill calls "
          f"{rnn.prefills} decode steps {rnn.decode_steps}, launches {got} "
          f"| peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"| {smi}")
    assert group.dispatch_log == ["chat", "chat", "rnn", "chat", "rnn",
                                  "rnn"], list(group.dispatch_log)
    assert group.fairness_counters == {"chat": 3, "rnn": 3}
    assert [r.uid for r in results] == list(range(6))
    assert all(len(r.tokens) == 8 for r in results)
    assert got == {"flash_attention": cfgs["chat"].num_layers * chat.prefills,
                   "wkv6": cfgs["rnn"].num_layers
                   * (rnn.prefills + rnn.decode_steps)}, got
    assert chat.prefills >= 2 and rnn.prefills == 2 and rnn.decode_steps
    for name, cfg in cfgs.items():
        solo = make_engine_group(cfg, params[name], ServeConfig(
            event_loops=1, poll="busy", max_batch=2, max_len=1536,
            comm=comm), seed=0, device=dev)
        solo.submit([Request(r.uid, r.prompt, max_new=r.max_new)
                     for r in reqs if r.tenant == name])
        alone = {r.uid: r.tokens.tolist() for r in solo.run(threads=False)}
        mine = {r.uid: r.tokens.tolist() for r in results if r.uid in alone}
        print(f"[tenants] {name} tokens in the group {mine}; alone {alone}")
        assert mine == alone, name
    del group, solo, params
    release_memory("before the tenant CLI")

    # the --tenant CLI as a user runs it
    argv = [sys.executable, "-m", "repro_torch.launch.serve",
            "--tenant", f"chat={cfgs['chat'].name}:2",
            "--tenant", f"rnn={cfgs['rnn'].name}:1",
            "--requests", "6", "--max-new", "4", "--device", dev.type]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    t0 = time.perf_counter()
    run = subprocess.run(argv, cwd=here, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        print(f"[tenants-cli]   {line}")
    print(f"[tenants-cli] {' '.join(argv[1:])}: rc {run.returncode}, "
          f"{wall:.2f} s | {smi}")
    assert run.returncode == 0, run.stderr[-4000:]
    assert ("[serve] tenants: fairness={'chat': 3, 'rnn': 3} dispatch="
            "['chat', 'chat', 'rnn', 'chat', 'rnn', 'rnn']") in run.stdout, \
        run.stdout
    assert "[serve] 6 requests, 24 tokens" in run.stdout, run.stdout
    return got


class PrefillCalls:
    """Counts the prefill calls of every serve step while installed in
    ``models.api.prefill`` (the serve steps call it through the module),
    so the flash launches of runs whose groups are built inside a
    harness can be checked per prefill."""

    def __init__(self):
        from repro_torch.models import api
        self.api, self.orig, self.calls = api, api.prefill, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.orig(*args, **kwargs)

    def __enter__(self):
        self.api.prefill = self
        return self

    def __exit__(self, *exc):
        self.api.prefill = self.orig


def serve_chaos(gen, smi, ring) -> int:
    """Phase 10b: the chaos plane on qwen2-0.5b, whole, full width, bf16,
    through ``hadronio`` over ``ring`` (phase 4b's one-peer NCCL ring):
    the harness's serve shape (4 channels, ``aggregate=channel``,
    ``flush=ready``, 2 loops, drained inline) at 4 MiB slices and a
    ``max_len`` that fits 8 requests of 64..512-token prompts and 8..16
    new tokens. Two ``run_baseline`` (the second is the RTT baseline),
    then each of the six scenarios at seed 11 (whose ``dropped_flush``
    plan holds drops as well as dups).
    Checks for every scenario full token recovery against the baseline,
    a non-empty fired trace and flash in every prefill (storm admissions
    included: one launch per layer per prefill call); per scenario the
    stalls, delays, drops (under a ``stats_scope``), allocations, the
    migrated channels and that no storm uid is among the recovered
    tokens; and that ``dropped_flush`` run twice at the seed fires and
    drains identically. Prints each scenario's RTT percentiles, its
    p99.9 inflation over the baseline and its wall time. Returns the
    flash launches, the params, the baseline and its wall time (phases
    11 and 12 serve the same model against it)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.backends import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.elastic import reshard_affinity
    from repro_torch.models import api
    from repro_torch.serving import chaos, channel_affinity
    dev = gen.device
    cfg = get_config("qwen2-0.5b")
    params = api.init(gen, cfg, device=dev)
    serve = chaos.chaos_serve_config("hadronio", 2, slice_bytes=4 << 20,
                                     max_len=528)
    reqs = chaos.make_requests(8, vocab_size=cfg.vocab_size,
                               prompt_len=(64, 513), max_new=(8, 16))
    seed = 11
    assert "drop" in {e.kind for e in chaos.make_plan(
        "dropped_flush", seed, n_channels=4).events}
    ops.flash_attention.launches = 0
    with PrefillCalls() as pc:
        # the first run pays the wire's first calls; the second is the
        # RTT baseline
        warm = chaos.run_baseline(cfg, params, serve, reqs, device=dev,
                                  ring=ring)
        t0 = time.perf_counter()
        base = chaos.run_baseline(cfg, params, serve, reqs, device=dev,
                                  ring=ring)
        torch.cuda.synchronize()
        wall = base_wall = time.perf_counter() - t0
    total = ops.flash_attention.launches
    assert warm.tokens == base.tokens
    ps = chaos.slo.rtt_percentiles(base.rtts)
    print(f"[chaos] baseline qwen2-0.5b hadronio 2 loops, prompts "
          f"{[len(r.prompt) for r in reqs]}: "
          f"{sum(map(len, base.tokens.values()))} tokens, prefill calls "
          f"{pc.calls}, flash {total} | RTT p50 {ps['p50'] * 1e3:.3f} ms "
          f"p99 {ps['p99'] * 1e3:.3f} ms p99.9 {ps['p99.9'] * 1e3:.3f} ms | "
          f"{wall:.3f} s | {smi}")
    assert total == cfg.num_layers * pc.calls and pc.calls >= 8
    assert [len(base.tokens[r.uid]) for r in reqs] == \
        [r.max_new for r in reqs]
    runs = {}
    for scenario in chaos.SCENARIOS + ("dropped_flush",):
        ops.flash_attention.launches = 0
        with PrefillCalls() as pc, pipeline.stats_scope() as st:
            t0 = time.perf_counter()
            res = chaos.run_scenario(scenario, cfg, params, serve, reqs,
                                     seed=seed, baseline=base, device=dev,
                                     ring=ring)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        flash = ops.flash_attention.launches
        total += flash
        rep, pst = res.report, res.poll_stats
        print(f"[chaos] {scenario} seed {seed}: recovered {rep.recovered}, "
              f"fired {list(res.fired)[:6]}{'...' if len(res.fired) > 6 else ''}"
              f" ({len(res.fired)}), drains {list(res.drains)}, moved "
              f"{res.moved_channels}, stalls {pst.stalls} delays "
              f"{pst.delays}, drops {st.drops} dups {st.dups} allocs "
              f"{st.allocs}, collectives {len(res.emissions)}, prefill "
              f"calls {pc.calls}, flash {flash} | RTT p50 "
              f"{rep.fault['p50'] * 1e3:.3f} ms p99 "
              f"{rep.fault['p99'] * 1e3:.3f} ms p99.9 "
              f"{rep.fault['p99.9'] * 1e3:.3f} ms, p99.9 inflation "
              f"{rep.p999_inflation:.3f}x | {wall:.3f} s | {smi}")
        assert rep.recovered and res.tokens == base.tokens, scenario
        assert res.fired, scenario
        assert flash == cfg.num_layers * pc.calls and pc.calls >= 4, \
            (scenario, flash, pc.calls)
        kinds = [f[2] for f in res.fired]
        if scenario == "stalled_loop":
            assert pst.stalls == kinds.count("stall") > 0
        elif scenario == "slow_channel":
            assert pst.delays == kinds.count("delay") > 0
        elif scenario == "dropped_flush":
            assert st.drops == kinds.count("drop") > 0
            assert st.dups == kinds.count("dup")
        elif scenario == "mem_pressure":
            assert st.allocs > 0 and kinds.count("pressure") > 0
        elif scenario == "reshard_mid_request":
            new_loops = res.plan.events[0].target
            assert res.moved_channels == reshard_affinity(
                4, channel_affinity(4, 2), new_loops)[1] != ()
        elif scenario == "admission_storm":
            assert kinds.count("burst") > 0
            assert all(u < chaos.STORM_UID_BASE for u in res.tokens)
        if scenario in runs:
            first = runs[scenario]
            assert (res.fired, res.drains) == (first.fired, first.drains)
            print(f"[chaos] {scenario} replayed at seed {seed}: fired and "
                  "drains identical")
        runs[scenario] = res
    assert not pipeline.fault_active()
    return total, params, base, base_wall


# the healing kind each supervised scenario must record (the reference's
# tests/test_supervisor.py map)
HEAL_KINDS = {"slow_channel": "quarantine", "stalled_loop": "quarantine",
              "dropped_flush": "retry", "admission_storm": "backpressure",
              "reshard_mid_request": "resize", "mem_pressure": "retry"}
SPAN_KINDS = ("emission", "stage", "flush", "build", "prefill", "decode",
              "admission", "drain", "heal")


def serve_supervised(smi, ring, params, base, dev) -> int:
    """Phase 11: the self-healing supervisor and the telemetry plane on
    phase 10b's model, params, serve shape, requests and baseline
    (qwen2-0.5b whole, bf16, ``hadronio`` over ``ring``, 4 channels,
    ``channel``/``ready``, 4 MiB slices, 2 loops drained inline, seed 11).
    (a) ``chaos.run_supervised`` for each of the six scenarios (and
    ``dropped_flush`` twice): tokens equal to the baseline's, every
    client uid ``served``, a non-empty healing trace holding the
    scenario's kind (``HEAL_KINDS``), the replay's trace identical, one
    flash launch per layer per prefill call (``PrefillCalls``). (b) A
    traced baseline and a traced supervised ``dropped_flush``
    (``obs.capture``): together every kind of ``SPAN_KINDS``, both
    well-formed, no span evicted from the ring, tokens equal to the
    untraced runs', the Chrome-trace JSON written under ``build/``
    loading back; the baseline's wall time traced against untraced, in
    turns (three each), and one span's host cost. (c) Two seeded supervised runs give byte-identical
    deterministic metrics snapshots (``obs.collect``). (d) ``launch.serve
    --supervised --trace-out --metrics-out`` as a subprocess: rc 0, both
    files load. Returns the flash launches of (a) to (c)."""
    from repro_torch import obs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.backends import pipeline
    from repro_torch.kernels import ops
    from repro_torch.serving import Supervisor, SupervisorConfig, chaos
    cfg = get_config("qwen2-0.5b")
    serve = chaos.chaos_serve_config("hadronio", 2, slice_bytes=4 << 20,
                                     max_len=528)
    reqs = chaos.make_requests(8, vocab_size=cfg.vocab_size,
                               prompt_len=(64, 513), max_new=(8, 16))
    seed = 11
    total = 0

    def checked(label, run):
        """``run()`` under the flash counter and PrefillCalls: one launch
        per layer per prefill call; returns (result, wall s)."""
        nonlocal total
        ops.flash_attention.launches = 0
        with PrefillCalls() as pc:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        flash = ops.flash_attention.launches
        total += flash
        assert flash == cfg.num_layers * pc.calls and pc.calls >= 4, \
            (label, flash, pc.calls)
        return out, wall, pc.calls

    def supervised(scenario):
        return chaos.run_supervised(scenario, cfg, params, serve, reqs,
                                    seed=seed, baseline=base, device=dev,
                                    ring=ring)

    # -- a. the six scenarios under the supervisor
    traces = {}
    for scenario in chaos.SCENARIOS + ("dropped_flush",):
        res, wall, calls = checked(scenario, lambda: supervised(scenario))
        rep = res.report
        kinds = [k for _, k, _, _ in res.trace]
        print(f"[supervise] {scenario} seed {seed}: recovered "
              f"{rep.recovered}, outcomes {sorted({o.status for o in res.outcomes.values()})}, "
              f"{len(res.trace)} healing actions {kinds}, MTTR "
              f"{rep.mttr_s * 1e3 if rep.mttr_s is not None else None} ms, "
              f"fired {len(res.fired)}, prefill calls {calls}, flash "
              f"{calls * cfg.num_layers} | RTT p50 "
              f"{rep.fault['p50'] * 1e3:.3f} ms p99.9 "
              f"{rep.fault['p99.9'] * 1e3:.3f} ms | {wall:.3f} s | {smi}")
        assert rep.recovered and res.tokens == base.tokens, scenario
        assert {u: o.status for u, o in res.outcomes.items()
                if u < chaos.STORM_UID_BASE} == \
            {r.uid: "served" for r in reqs}, (scenario, res.outcomes)
        assert res.trace and HEAL_KINDS[scenario] in kinds, \
            (scenario, res.trace)
        if scenario in traces:
            assert res.trace == traces[scenario], scenario
            print(f"[supervise] {scenario} replayed at seed {seed}: "
                  "healing trace identical")
        traces[scenario] = res.trace
    assert not pipeline.fault_active()

    # -- b. traced runs: the span taxonomy, well-formed, tokens unchanged
    def baseline():
        return chaos.run_baseline(cfg, params, serve, reqs, device=dev,
                                  ring=ring)

    walls = {"untraced": [], "traced": []}
    recs = {}
    for mode in ("untraced", "traced", "traced", "untraced", "untraced",
                 "traced"):
        if mode == "traced":
            with obs.capture() as rec:
                got, wall, _ = checked("traced baseline", baseline)
            recs["baseline"] = rec
        else:
            got, wall, _ = checked("untraced baseline", baseline)
        assert got.tokens == base.tokens, mode
        walls[mode].append(wall)
    with obs.capture() as rec:
        res, wall, _ = checked("traced dropped_flush",
                               lambda: supervised("dropped_flush"))
    assert res.tokens == base.tokens and res.trace == \
        traces["dropped_flush"]
    recs["dropped_flush"] = rec
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    for name, rec in recs.items():
        ok, problems = obs.well_formed(rec)
        counts = {k: len(rec.spans_of(k)) for k in rec.kinds()}
        path = os.path.join(HERE, "build", f"trace_{name}.json")
        rec.write(path)
        with open(path) as f:
            doc = json.load(f)
        print(f"[trace] {name}: {sum(counts.values())} spans {counts}, "
              f"dropped {rec.dropped}, forced closes {rec.forced_closes}, "
              f"well-formed {ok} -> {path} ({len(doc['traceEvents'])} "
              f"events) | {smi}")
        assert ok, (name, problems[:4])
        assert rec.dropped == 0 and len(doc["traceEvents"]) == \
            sum(counts.values())
    kinds = set(recs["baseline"].kinds()) | set(recs["dropped_flush"].kinds())
    assert set(SPAN_KINDS) <= kinds, kinds
    assert set(SPAN_KINDS) - {"heal"} <= set(recs["baseline"].kinds())
    med = {m: statistics.median(w) for m, w in walls.items()}
    # the recorder's own cost: one span opened and closed, on this host
    n_spans = len(recs["baseline"].spans)
    with obs.capture():
        t0 = time.perf_counter()
        for _ in range(10_000):
            with obs.span("decode", "probe"):
                pass
        per_span = (time.perf_counter() - t0) / 10_000
    print(f"[trace] baseline wall traced {walls['traced']} s vs untraced "
          f"{walls['untraced']} s: median overhead "
          f"{(med['traced'] / med['untraced'] - 1) * 100:.2f}%; one span "
          f"costs {per_span * 1e6:.3f} us on the host, x {n_spans} spans = "
          f"{per_span * n_spans * 1e3:.3f} ms a run "
          f"({per_span * n_spans / med['untraced'] * 100:.4f}% of the "
          f"untraced median) | {smi}")

    # -- c. the metrics snapshot of two seeded supervised runs
    snaps = []
    for _ in range(2):
        sup = Supervisor(cfg, params, serve, device=dev, ring=ring,
                         seed=seed, config=SupervisorConfig(
                             dispatch_quantum=4))
        with pipeline.stats_scope():
            sup.submit(reqs)
            out, _, _ = checked("supervised snapshot",
                                lambda: sup.run(threads=False))
            reg = obs.collect(supervisor=sup, mode="hadronio")
        assert {r.uid: tuple(r.tokens.tolist()) for r in out} == \
            base.tokens
        snaps.append(reg.to_json(deterministic=True))
    det = json.loads(snaps[0])
    print(f"[metrics] two seeded supervised runs: deterministic snapshot "
          f"{len(snaps[0])} bytes, {len(det['gauges'])} gauges, identical "
          f"{snaps[0] == snaps[1]}, rounds "
          f"{det['gauges']['supervisor.rounds{mode=hadronio}']} | {smi}")
    assert snaps[0] == snaps[1]

    # -- d. the supervised, traced CLI as a user runs it
    trace_path = os.path.join(HERE, "build", "cli_trace.json")
    metrics_path = os.path.join(HERE, "build", "cli_metrics.json")
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            cfg.name, "--requests", "8", "--max-new", "8", "--batch", "2",
            "--event-loops", "1", "--supervised", "--max-loops", "2",
            "--scale-up-depth", "2", "--dispatch-quantum", "2",
            "--comm-mode", "hadronio", "--aggregate", "channel", "--flush",
            "ready", "--trace-out", trace_path, "--metrics-out",
            metrics_path, "--device", dev.type]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    run = subprocess.run(argv, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        print(f"[supervise-cli]   {line}")
    print(f"[supervise-cli] {' '.join(argv[1:])}: rc {run.returncode}, "
          f"{wall:.2f} s | {smi}")
    assert run.returncode == 0, run.stderr[-4000:]
    with open(trace_path) as f:
        cli_trace = json.load(f)
    with open(metrics_path) as f:
        cli_metrics = json.load(f)
    assert cli_trace["traceEvents"] and cli_trace["otherData"][
        "open_spans"] == 0
    assert cli_metrics["gauges"]["group.loops{mode=hadronio}"] >= 1
    assert "[serve] 8 requests, 64 tokens" in run.stdout, run.stdout
    return total


# phase 12's slices: a B=2 (or B=1) decode payload of qwen2-0.5b's logits,
# 1.2 MB, spans several, so each loop's two lanes both carry it and the
# leader split runs; at phase 10b's 4 MiB it is one slice on one lane
POD_SLICE = 512 << 10


class EmissionLog:
    """While installed: every staged emission's kind (``begin_emission``,
    which the emissions call through the module) and every channel
    collective (the collective hook) in issue order; ``emissions()``
    splits the log into ``(kind, [collective kinds])`` per emission."""

    def __init__(self):
        from repro_torch.core import channels
        from repro_torch.core.backends import pipeline
        self.channels, self.pipeline = channels, pipeline
        self.orig, self.log = pipeline.begin_emission, []

    def __enter__(self):
        def begin(ctx, n_items, kind="all_reduce", **kw):
            self.log.append(("begin", kind))
            return self.orig(ctx, n_items, kind, **kw)
        self.pipeline.begin_emission = begin
        self.channels.set_collective_hook(
            lambda c, kind: self.log.append((c, kind)))
        return self

    def __exit__(self, *exc):
        self.pipeline.begin_emission = self.orig
        self.channels.clear_collective_hook()

    def emissions(self) -> list:
        out = []
        for c, kind in self.log:
            if c == "begin":
                out.append((kind, []))
            else:
                out[-1][1].append(kind)
        return out


def serve_pods(smi, params, base, flat_wall, dev) -> int:
    """Phase 12: the two-level pod fabric on qwen2-0.5b whole, bf16, with
    phase 10b's params, requests and baseline. On the one-peer NCCL group
    a second ring, ``Ring(channels=4, pods=1, pod_axis="pod")`` (the
    reference's degenerate ``(1, 1)`` pod mesh: every split collective is
    a real NCCL call on its own in-pod or cross-pod communicator, 12 in
    all), built after ``release_memory`` and closed after the phase.
    Served through ``make_engine_group`` (pods detected from the ring):
    ``hadronio``, 4 channels, ``aggregate=channel``, ``POD_SLICE``
    slices, ``leader_channels=1``, 2 loops drained inline.
    (a) ``hierarchical=True`` under ``flush=ready`` (in turns with the
    flat emission, ``hierarchical=False``, on the same ring: flat, pod,
    pod, flat) and under ``step``: tokens bitwise phase 10b's, flash 24
    per prefill call, every decode emission ``in_pod_reduce_scatter`` ->
    ``cross_pod_all_reduce`` -> ``in_pod_all_gather`` and every prefill
    emission ``in_pod_all_gather`` -> ``cross_pod_all_gather``: one
    cross-pod collective per emission (the loop's leader lanes), where the
    flat emission issues one collective per lane the loop owns (2).
    (b) 4 loops on the 4 channels: every pool is one lane, so the
    channel's own two-level all-reduce runs (the hook notes
    ``all_reduce``, no split kind); tokens bitwise. (c) (a) under
    ``ready`` traced: every ``leader_flush`` inside a ``flush`` of its
    own emission, well-formed, none evicted. (d) walls on the host clock
    beside phase 10b's flat baseline (``flat_wall``), the flash count,
    and the card's free memory and PyTorch's peak before and after the
    pod ring's communicators. Returns the flash launches."""
    from repro_torch import obs
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.channels import Ring
    from repro_torch.kernels import ops
    from repro_torch.serving import chaos
    cfg = get_config("qwen2-0.5b")
    reqs = chaos.make_requests(8, vocab_size=cfg.vocab_size,
                               prompt_len=(64, 513), max_new=(8, 16))
    release_memory("before the pod ring")
    torch.cuda.reset_peak_memory_stats()
    free0 = torch.cuda.mem_get_info()[0]
    pod = Ring(channels=4, pods=1, pod_axis="pod")
    assert pod.shape == {"pod": 1, "data": 1}
    total = 0

    def serve(hier, loops=2, flush="ready"):
        return ServeConfig(
            event_loops=loops, poll="busy", max_batch=2, max_len=528,
            comm=CommConfig(mode="hadronio", channels=4,
                            slice_bytes=POD_SLICE, aggregate="channel",
                            flush=flush, hierarchical=hier,
                            leader_channels=1))

    def run(label, sc):
        """One baseline run on the pod ring: tokens equal to phase 10b's,
        one flash launch per layer per prefill call; (wall s, log)."""
        nonlocal total
        ops.flash_attention.launches = 0
        with PrefillCalls() as pc, EmissionLog() as log:
            t0 = time.perf_counter()
            got = chaos.run_baseline(cfg, params, sc, reqs, device=dev,
                                     ring=pod)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        flash = ops.flash_attention.launches
        total += flash
        assert got.tokens == base.tokens, label
        assert flash == cfg.num_layers * pc.calls and pc.calls >= 4, \
            (label, flash, pc.calls)
        ems = log.emissions()
        kinds = sorted({k for _, ks in ems for k in ks})
        print(f"[pods] {label}: tokens == phase 10b's, prefill calls "
              f"{pc.calls}, flash {flash}, {len(ems)} emissions, "
              f"{sum(map(len, (ks for _, ks in ems)))} collectives "
              f"{kinds} | {wall:.3f} s | {smi}")
        return wall, ems

    def check_leader(label, ems):
        """Every emission through the leader split, one cross-pod
        collective each."""
        want = {"all_reduce": ["in_pod_reduce_scatter",
                               "cross_pod_all_reduce", "in_pod_all_gather"],
                "all_gather": ["in_pod_all_gather", "cross_pod_all_gather"]}
        kinds = {k for k, _ in ems}
        assert kinds == set(want), (label, kinds)
        for kind, ks in ems:
            assert ks == want[kind], (label, kind, ks)
        n = sum(1 for k, _ in ems if k == "all_reduce")
        print(f"[pods] {label}: {n} decode and {len(ems) - n} prefill "
              "emissions, each " + " -> ".join(want["all_reduce"]) + " / "
              + " -> ".join(want["all_gather"]) + ": 1 cross-pod "
              "collective per emission")

    # -- a. flat and pod emission in turns, then the step schedule
    walls = {"flat": [], "pod": []}
    warm, ems = run("pod warm-up (first collectives of 12 communicators)",
                    serve(True))
    check_leader("pod ready warm-up", ems)
    free1 = torch.cuda.mem_get_info()[0]
    for name in ("flat", "pod", "pod", "flat"):
        wall, ems = run(f"{name} ready", serve(name == "pod"))
        walls[name].append(wall)
        if name == "pod":
            check_leader("pod ready", ems)
        else:
            assert {k for _, ks in ems for k in ks} == {"all_reduce",
                                                        "all_gather"}
            decode = [ks for k, ks in ems if k == "all_reduce"]
            assert decode and all(len(ks) == 2 for ks in decode), decode
    wall, ems = run("pod step", serve(True, flush="step"))
    check_leader("pod step", ems)
    walls["pod step"] = [wall]

    # -- b. one lane per loop: the channel's own two-level all-reduce
    wall, ems = run("pod, 4 loops", serve(True, loops=4))
    assert {k for _, ks in ems for k in ks} == {"all_reduce", "all_gather"}
    assert all(len(ks) == 1 for _, ks in ems), ems[:4]
    walls["pod 4 loops"] = [wall]

    # -- c. traced: every leader flush inside a flush of its own emission
    with obs.capture() as rec:
        wall, ems = run("pod ready traced", serve(True))
    check_leader("pod ready traced", ems)
    leads = rec.spans_of("leader_flush")
    for lead in leads:
        host = obs.containing(rec, lead, "flush")
        assert host is not None, lead
        assert obs.containing(rec, lead, "emission") is \
            obs.containing(rec, host, "emission"), lead
    ok, problems = obs.well_formed(rec)
    counts = {k: len(rec.spans_of(k)) for k in rec.kinds()}
    print(f"[pods] traced: {sum(counts.values())} spans {counts}, "
          f"{len(leads)} leader flushes each inside a flush of its own "
          f"emission, dropped {rec.dropped}, well-formed {ok} | {smi}")
    assert ok and rec.dropped == 0 and len(leads) == len(ems), problems[:4]

    # -- d. walls, flash, memory
    peak = torch.cuda.max_memory_allocated()
    pod.close()
    free2 = torch.cuda.mem_get_info()[0]
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"[pods] walls (host clock, 8 requests): pod ready "
          f"{walls['pod']} s, flat ready {walls['flat']} s on the pod ring "
          f"(medians {med['pod']:.3f} / {med['flat']:.3f}), pod step "
          f"{walls['pod step'][0]:.3f} s, 4 loops "
          f"{walls['pod 4 loops'][0]:.3f} s, warm-up {warm:.3f} s; phase "
          f"10b's flat baseline (4 MiB slices, no pod axis) {flat_wall:.3f} "
          f"s | flash {total} | free on the card {free0 / 1e9:.3f} GB "
          f"before the pod ring, {free1 / 1e9:.3f} GB after its first "
          f"collectives, {free2 / 1e9:.3f} GB after close; PyTorch's peak "
          f"{peak / 1e9:.2f} GB | {smi}")
    return total


DRYRUN_ARCH = "qwen2-0.5b"
DRYRUNS = (("pod", ["--mode", "hadronio"]),
           ("multipod", ["--mode", "hadronio", "--mesh", "multipod",
                         "--global-batch", "512", "--aggregate", "channel"]),
           ("multipod flat", ["--mode", "hadronio", "--mesh", "multipod",
                              "--global-batch", "512", "--aggregate",
                              "channel", "--flat-collectives"]),
           ("gspmd", ["--mode", "gspmd"]))


def start_dryruns(out_dir: str) -> dict:
    """Phase 13c's dry runs of ``DRYRUN_ARCH`` x train_4k (``DRYRUNS``:
    hadronio on the 256-peer pod, on 2 pods of 256 with the leader
    emission and flat, and gspmd), one subprocess each, started together,
    each with its own ``--out`` under ``out_dir``, the card hidden (a
    fake process group and fake tensors compute nothing) and one CPU
    thread. Returns {label: (process, out dir, start time)}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONWARNINGS="ignore")
    procs = {}
    for label, extra in DRYRUNS:
        out = os.path.join(out_dir, label.replace(" ", "_"))
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", "train_4k", "--out", out] + extra,
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out, time.perf_counter())
    return procs


def finish_dryruns(smi, procs: dict, timeout_s: float = 600.0) -> None:
    """Phase 13c: wait for ``start_dryruns``' processes (every one still
    running at ``timeout_s`` is killed and fails the phase) and check
    their artifacts: the three hadronio runs ``ok``, the leader emission
    over 2 pods issuing fewer cross-pod collectives
    (``cross_pod_collective_count`` at 256 peers a pod) than the flat
    schedule, and gspmd recorded as ``fail`` with the GSPMD family's
    named error, rc 1. Prints each run's wall and traced seconds, its
    collectives, counted FLOPs and memory estimate."""
    from repro_torch.launch import dryrun
    ends, deadline = {}, time.perf_counter() + timeout_s
    try:
        while len(ends) < len(procs):
            for label, (proc, _, _) in procs.items():
                if label not in ends and proc.poll() is not None:
                    ends[label] = time.perf_counter()
            assert time.perf_counter() < deadline, \
                f"dry runs still running after {timeout_s} s"
            time.sleep(0.2)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    arts = {}
    for label, (proc, out, t0) in procs.items():
        log = proc.stdout.read()
        mesh = "multipod" if label.startswith("multipod") else "pod"
        mode = "gspmd" if label == "gspmd" else "hadronio"
        with open(dryrun.artifact_path(DRYRUN_ARCH, "train_4k", mesh, mode,
                                       out)) as f:
            art = arts[label] = json.load(f)
        wall = ends[label] - t0
        if label == "gspmd":
            assert proc.returncode == 1 and art["status"] == "fail", log
            assert "GSPMD step family" in art["error"], art["error"]
            print(f"[dryrun] gspmd: status fail, rc 1, {wall:.1f} s wall: "
                  f"{art['error'][:100]}")
            continue
        assert proc.returncode == 0 and art["status"] == "ok", log[-3000:]
        mem, coll, cp = (art["memory_analysis"], art["collectives"],
                         art["cross_pod"])
        print(f"[dryrun] {label} ({art['n_chips']} fake peers, global "
              f"batch {art['global_batch']}, aggregate "
              f"{art['comm']['aggregate']}, hierarchical "
              f"{art['comm']['hierarchical']}): status ok, {wall:.1f} s "
              f"wall, traced step {art['compile_seconds']} s; collectives "
              f"{coll['counts']} {coll['total_bytes']} B, cross-pod "
              f"{cp['cross_pod']} in-pod {cp['in_pod']}; counted FLOPs "
              f"{art['cost_analysis']['flops']:.4e} vs model "
              f"{art['model_flops_per_chip']:.4e} per peer (useful "
              f"{art['useful_flops_ratio']:.4f}); memory estimate: "
              f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, "
              f"temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB, peak "
              f"{mem['peak_size_in_bytes'] / 1e9:.3f} GB; roofline "
              f"bottleneck {art['roofline']['bottleneck']} (data-sheet "
              f"figures) | {smi}")
    hier = arts["multipod"]["cross_pod"]["cross_pod_total"]
    flat = arts["multipod flat"]["cross_pod"]["cross_pod_total"]
    print(f"[dryrun] 2 pods x 256: cross-pod collectives per step, leader "
          f"emission {hier}, flat {flat}")
    assert 0 < hier < flat, (hier, flat)


def analysis_phase(smi, params, ring, dev) -> dict:
    """Phase 13: the analysis layer (``launch/hlo_analysis``) on the card,
    and the dry run. (a) qwen2-0.5b at full width, phase 5's step
    (S=1024, B=4, ``hadronio``, ``bf16``, ``pallas``, one peer) through a
    ``Trainer``: one step recorded, its collectives by kind and result
    bytes those of the ring plan (``n_slices`` all-reduces of a slice's
    bf16 wire, and the loss's), pack and unpack launched once each; its
    counted FLOPs against ``model_flops``, its memory, the median of
    steps 2-5 of an unrecorded run, ``roofline_terms`` and the compute
    share ``model_flops / (t * PEAK_FLOPS)``. Then the dry runs start
    (``start_dryruns``). (b) on phase 4b's ``ring`` with ``params``
    (qwen2-0.5b, bf16): one recorded ``hadronio`` prefill (B=2, S=1024)
    and decode step, each with a collective position ``0 < first <
    total``, 24 flash launches in the prefill (the recorder hides no
    kernel), and ``gspmd``'s local decode with none. (d) two
    ``hadronio_rs`` steps (``bf16``, ``pallas``) on the degenerate pod
    ring ``Ring(channels=4, pods=1, pod_axis="pod")`` (two-level
    collectives, the in-pod ZeRO-1 group) and on a flat ring from one
    state: losses bitwise equal. (c) ``finish_dryruns``. Returns the
    kernel launches of the phase."""
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import aggregation as agg
    from repro_torch.core.channels import Ring
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import Trainer
    from repro_torch.models import api
    from repro_torch.serving import dispatch
    cfg = get_config("qwen2-0.5b")
    shape = ShapeConfig("smoke", "train", seq_len=1024, global_batch=4)
    launches = {"pack_slices": 0, "unpack_slices": 0, "flash_attention": 0}

    def counted(fn):
        """``fn()`` with the three wrappers' launches added to
        ``launches``; returns (its result, its launches)."""
        for name in launches:
            getattr(ops, name).launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: getattr(ops, name).launches for name in launches}
        for name, n in got.items():
            launches[name] += n
        return out, got

    def train_run(mode):
        return RunConfig(model=cfg, shape=shape, total_steps=5,
                         warmup_steps=1, seed=0,
                         comm=CommConfig(mode=mode, channels=4,
                                         compress="bf16", pack="pallas"))

    # -- a. one recorded train step against the ring plan -------------------
    release_memory("before phase 13's trainer")
    run = train_run("hadronio")
    trainer = Trainer(run, device=dev, log_every=10)
    try:
        state = trainer.init_state()
        batches = [trainer.batch(i) for i in range(2)]
        prof, got = counted(lambda: hlo.profile(trainer.step_fn, state,
                                                batches[0]))
        plan = agg.make_plan(state.params, run.comm)
        wire = torch.finfo(torch.bfloat16).bits // 8
        loss = prof.out[1]["loss"]
        coll = hlo.collective_stats(prof.log)
        want = ({"all-reduce": plan.n_slices + 1},
                {"all-reduce": plan.n_slices * plan.slice_elems * wire
                 + loss.numel() * loss.element_size()})
        flops, mem = prof.flops, prof.memory
        cost = hlo.costs(prof)
        print(f"[analysis] recorded train step: {len(prof.log)} ops, "
              f"collectives {coll.counts} {coll.bytes_} B; the ring plan: "
              f"{plan.n_slices} slices x {plan.slice_elems} elems x {wire} "
              f"B + the loss's {loss.element_size()} B; launches {got}; "
              f"memory {mem}")
        assert (coll.counts, coll.bytes_) == want, (coll.as_dict(), want)
        assert got == {"pack_slices": 1, "unpack_slices": 1,
                       "flash_attention": 0}, got
        del prof, loss
        out, got = counted(lambda: trainer.run_loop(state))
        assert got == {"pack_slices": 5, "unpack_slices": 5,
                       "flash_attention": 0}, got
        assert all(np.isfinite(out["losses"])), out["losses"]
        t_s = statistics.median(out["step_s"][1:])
        del out
    finally:
        trainer.close()
    mf = hlo.model_flops(cfg, shape)
    terms = hlo.roofline_terms(
        flops=mf, hbm_bytes=hlo.analytic_hbm_bytes(cfg, shape, 1, tp=1,
                                                   dp=1),
        collective_bytes=coll.total_bytes, n_chips=1)
    print(f"[analysis] qwen2-0.5b train step (B=4, S=1024, hadronio/bf16/"
          f"pallas): counted FLOPs {flops:.6e}, model_flops {mf:.6e} "
          f"(counted / model {flops / mf:.4f}); pre-fusion bytes_accessed "
          f"{cost['bytes_accessed']:.6e}; median step (steps 2-5, not "
          f"recorded) {t_s * 1e3:.2f} ms; roofline at the data sheet's "
          f"peaks {terms}; compute share model_flops / (t x PEAK_FLOPS) "
          f"{mf / (t_s * hlo.PEAK_FLOPS):.4f} | {smi}")
    assert flops > mf > 0

    dry = start_dryruns(os.path.join(HERE, "build", "dryrun"))
    try:
        # -- b. the served path's emission position -------------------------
        toks = torch.randint(cfg.vocab_size, (2, 1024), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(13))
        big = {"tokens": toks,
               "last_pos": torch.full((2,), 1023, device=dev)}
        wired = dispatch.make_serve_step(cfg, CommConfig(
            mode="hadronio", channels=4), ring=ring)
        local = dispatch.make_serve_step(cfg, CommConfig(mode="gspmd"))
        with hlo.record() as plog:
            (lp, cache), got = counted(lambda: wired.prefill(params, big))
        assert got["flash_attention"] == cfg.num_layers, got
        cache = api.grow_cache(cfg, cache, 1040)
        dec = {"token": lp.argmax(-1),
               "pos": torch.full((2,), 1024, device=dev)}
        pos = {"hadronio prefill": hlo.first_collective_position(plog)}
        for label, step in (("hadronio decode", wired),
                            ("gspmd local decode", local)):
            with hlo.record() as log:
                step.decode(params, cache, dec)
            torch.cuda.synchronize()
            pos[label] = hlo.first_collective_position(log)
        print(f"[analysis] served qwen2-0.5b (B=2, S=1024) on the one-peer "
              f"ring: first collective position {pos}; flash launches in "
              f"the recorded prefill {got['flash_attention']} | {smi}")
        for label in ("hadronio prefill", "hadronio decode"):
            first, total = pos[label]
            assert 0 < first < total, (label, pos[label])
        assert pos["gspmd local decode"] is None, pos
        del lp, cache, dec, big

        # -- d. the degenerate pod ring: hadronio_rs bitwise the flat ring's
        rs = train_run("hadronio_rs")
        release_memory("before phase 13's pod ring")
        losses = {}
        for label in ("flat", "pod"):
            r = Ring(channels=4) if label == "flat" else Ring(
                channels=4, pods=1, pod_axis="pod")
            try:
                step = steps_mod.make_train_step(rs, r)
                st = steps_mod.tac_state(state.params, rs,
                                         pod_size=r.pods)
                ls = []
                for b in batches:
                    (st, metrics), got = counted(lambda: step(st, b))
                    assert got["pack_slices"] == 1 and \
                        got["unpack_slices"] == 1, (label, got)
                    ls.append(metrics["loss"])
                losses[label] = ls
                del st
            finally:
                r.close()
        print(f"[analysis] hadronio_rs/bf16/pallas, 2 steps: losses "
              f"{[float(x) for x in losses['pod']]} on Ring(pods=1, "
              f"pod_axis='pod'), {[float(x) for x in losses['flat']]} flat "
              f"| {smi}")
        assert all(torch.equal(a, b) for a, b in zip(losses["pod"],
                                                     losses["flat"]))
        del state, batches
    except BaseException:
        for proc, _, _ in dry.values():     # stop them, then fail
            proc.kill()
            proc.wait()
        raise
    # -- c. the dry runs ----------------------------------------------------
    finish_dryruns(smi, dry)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    import torch.distributed as dist
    from repro_torch.configs.base import (CommConfig, RunConfig, ServeConfig,
                                          ShapeConfig)
    from repro_torch.configs.registry import get_config
    from repro_torch.core import aggregation as agg
    from repro_torch.core import tac
    from repro_torch.core.backends import get_backend
    from repro_torch.core.channels import Ring
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rglru as _rg
    from repro_torch.kernels import rwkv6_scan as _wk
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import Trainer
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import api
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.models.attention import (attend_chunked, attend_direct,
                                              expand_kv)
    from repro_torch.models.common import tree_map
    from repro_torch.serving import make_engine_group

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {kind} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 2. build (one nvcc per source, started together) -------------------
    t0 = time.perf_counter()
    names = ("flash_attention", "ring_pack", "rwkv6_scan", "rglru")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))
    print(f"[build] {', '.join(names)}: {time.perf_counter() - t0:.2f}s")
    for name in names:
        info = build.BUILD_INFO[name]
        print(f"[build] {name}: nvcc {info['seconds']:.2f}s -> "
              f"{info['path']}")
        for fn, line in ptxas_report(info["ptxas"]):
            print(f"[ptxas] {name} {fn[-48:]}: {line}")
        spills = spill_lines(info["ptxas"])
        assert not spills, f"{name}: ptxas reports spills: {spills}"
    # the bf16 flash kernels issue wgmma for both products and load K/V by
    # TMA: read off the compiled code
    sass = sass_counts(build.BUILD_INFO["flash_attention"]["path"])
    if sass is None:
        print("[sass] flash_attention: cuobjdump not found; not read")
    else:
        tc_fns = {fn: c for fn, c in sass.items() if "flash_fwd_tc" in fn}
        for fn, c in sorted(tc_fns.items()):
            print(f"[sass] flash_attention {fn[-60:]}: {c}")
        assert len(tc_fns) == 5 and all(
            sum(n for op, n in c.items() if op.startswith("HGMMA")) >= 2
            and any(op.startswith("UTMALDG") for op in c)
            for c in tc_fns.values()), tc_fns
    # the scans' asynchronous copies: the chunked WKV6 kernels and the
    # RG-LRU TMA instance load by TMA, the RG-LRU instance for other W by
    # cp.async (LDGSTS)
    for name, want in (("rwkv6_scan", {"wkv6_chunked": "UTMALDG"}),
                       ("rglru", {"rglru_fwdILb1": "UTMALDG",
                                  "rglru_fwdILb0": "LDGSTS"})):
        sass = sass_counts(build.BUILD_INFO[name]["path"])
        if sass is None:
            print(f"[sass] {name}: cuobjdump not found; not read")
            continue
        for fn, c in sorted(sass.items()):
            print(f"[sass] {name} {fn[-48:]}: {c}")
        for key, op in want.items():
            fns = {fn: c for fn, c in sass.items() if key in fn}
            assert fns and all(any(o.startswith(op) for o in c)
                               for c in fns.values()), (name, key, op, sass)

    # -- 3. kernel vs plain version ----------------------------------------
    # flash attention: bf16 runs the tensor-core kernel, f32 the FMA
    # kernel; k/v at their KV heads, read in place
    def qkv(b, s, h, dh, dtype, kv=None):
        kv = h if kv is None else kv
        return [torch.randn(sh, generator=gen, device=dev).to(dtype)
                for sh in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))]

    bf16, f32 = torch.bfloat16, torch.float32
    modes = (("causal", True, 0), ("window 48", True, 48),
             ("non-causal", False, 0))
    ragged = (1, 63, 65, 257)
    for dh in HEAD_DIMS:
        worst, worst_row, n_case = 0.0, 0.0, 0
        for kv in (1, 2, 4):
            for s_ in ragged:
                for mode, causal, window in modes:
                    q, k, v = qkv(2, s_, 4, dh, bf16, kv)
                    got = ops.flash_attention(q, k, v, causal=causal,
                                              window=window)
                    torch.cuda.synchronize()
                    want = ref.flash_attention(q, k, v, causal=causal,
                                               window=window)
                    name = f"flash bf16 Dh={dh} KV={kv} of H=4 S={s_} {mode}"
                    worst = max(worst, check_close(name, got, want, 3e-2,
                                                   5e-2, verbose=False))
                    worst_row = max(worst_row, check_rows(name, got, want,
                                                          verbose=False))
                    n_case += 1
        print(f"[check] flash bf16 Dh={dh}: {n_case} cases (B=2, H=4, KV "
              f"1/2/4, S {ragged}, causal / window 48 / non-causal): "
              f"max_abs_err={worst:.3e} (atol=3e-2, rtol=5e-2), worst row "
              f"rel_l2={worst_row:.3e} (bound {ROW_BOUND}) ok")
    cases = [  # name, dtype, B, S, H, KV, Dh, causal, window, atol, rtol
        ("bf16 causal S=1024", bf16, 4, 1024, 14, 2, 64, True, 0, 3e-2, 5e-2),
        ("bf16 window=48 S=257", bf16, 4, 257, 14, 14, 64, True, 48, 3e-2,
         5e-2),
        ("bf16 Dh=256 MQA S=300", bf16, 2, 300, 16, 1, 256, True, 0, 3e-2,
         5e-2),
        ("f32 Dh=16 S=257", f32, 2, 257, 3, 3, 16, True, 0, 2e-4, 2e-3),
        ("f32 Dh=128 S=257", f32, 2, 257, 3, 3, 128, True, 0, 2e-4, 2e-3),
        ("f32 Dh=32 window=48 S=200", f32, 2, 200, 3, 3, 32, True, 48, 2e-4,
         2e-3),
        ("f32 Dh=64 non-causal S=100", f32, 1, 100, 2, 2, 64, False, 0, 2e-4,
         2e-3),
        ("f32 Dh=64 KV=2 of 14 S=257", f32, 2, 257, 14, 2, 64, True, 0, 2e-4,
         2e-3),
        ("f32 Dh=256 KV=1 of 16 window=48 S=257", f32, 2, 257, 16, 1, 256,
         True, 48, 2e-4, 2e-3),
    ]
    for name, dt, b, s, h, kv, dh, causal, window, atol, rtol in cases:
        q, k, v = qkv(b, s, h, dh, dt, kv)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        check_close(name, got, want, atol, rtol)
        if dt == bf16:
            check_rows(name, got, want)

    # timing at the main paths' prefill shapes: K/V at their KV heads as
    # the models pass them, and expanded to H heads as they were passed
    # before (SDPA, the library yardstick, runs on expanded heads)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash_times(b, s, h, kv, dh, window, causal=True):
        q, k, v = qkv(b, s, h, dh, bf16, kv)
        ke, ve = expand_kv(k, h), expand_kv(v, h)
        shape = f"B={b} S={s} H={h} Dh={dh}"
        for heads, kk, vv in (("KV=" + str(kv), k, v), ("expanded", ke, ve)):
            name = (f"bf16 {shape} {heads} window={window} causal={causal} "
                    "(timed shape)")
            got = ops.flash_attention(q, kk, vv, causal=causal, window=window)
            want = ref.flash_attention(q, kk, vv, causal=causal,
                                       window=window)
            err = check_close(name, got, want, 3e-2, 5e-2)
            row = check_rows(name, got, want)
            if kk is k:
                t = {"err": err, "row_err": row}
        del got, want
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ke, ve))
        kw = dict(causal=causal, window=window)
        run = {"ms": lambda: ops.flash_attention(q, k, v, **kw),
               "expanded_ms": lambda: ops.flash_attention(q, ke, ve, **kw),
               "plain_ms": lambda: ref.flash_attention(q, k, v, **kw),
               "library_ms": lambda: sdpa(qt, kt, vt, is_causal=causal),
               "copies_ms": lambda: (expand_kv(k, h), expand_kv(v, h))}
        for key in ("ms", "expanded_ms", "plain_ms", "library_ms",
                    "copies_ms"):
            t[key] = time_ms(run[key], iters=5 if key == "plain_ms" else 20,
                             queued=True)
        t["ms_again"] = time_ms(run["ms"], queued=True)
        t["expanded_ms_again"] = time_ms(run["expanded_ms"], queued=True)
        t["bound_ms"], t["bound_by"] = attn_bound_ms(
            b, s, h, dh, causal, window, 2, H100_BF16_FLOPS, kv_heads=kv)
        t["bound_expanded_ms"], t["bound_expanded_by"] = attn_bound_ms(
            b, s, h, dh, causal, window, 2, H100_BF16_FLOPS)
        mode = "causal" if causal else "non-causal"
        print(f"[time] flash_attention {shape} bf16 {mode} window {window}: "
              f"KV={kv} in place {t['ms']:.4f} / {t['ms_again']:.4f} ms "
              f"(bound {t['bound_ms']:.4f} ms, {t['bound_by']}); expanded "
              f"{t['expanded_ms']:.4f} / {t['expanded_ms_again']:.4f} ms "
              f"(bound {t['bound_expanded_ms']:.4f} ms, "
              f"{t['bound_expanded_by']}); plain {t['plain_ms']:.4f} ms; sdpa "
              f"(expanded) {t['library_ms']:.4f} ms; the two expand_kv "
              f"copies saved {t['copies_ms']:.4f} ms | {smi}")
        return t

    fa64 = flash_times(2, 1024, 14, 2, 64, 0)
    fa256 = flash_times(2, 1024, 16, 1, 256, 2048)
    # the prefill shapes of phase 7's decoder-only families, Dh 128: MHA
    # at a head count that is not a power of two (qwen1.5-4b), GQA 24/2
    # (starcoder2-3b), 48/8 (dbrx-132b), 64/8 (qwen1.5-110b), and
    # mixtral's window of 4096 at S=4096 (equal to causal) and at its
    # served pair's S=4090 (a ragged last tile)
    fa128 = {f"B=2 S={s_} H={h} KV={kv} window={w}": flash_times(
        2, s_, h, kv, 128, w) for s_, h, kv, w in (
            (1024, 20, 20, 0), (1024, 24, 2, 0), (1024, 48, 8, 0),
            (1024, 64, 8, 0), (4096, 32, 8, 4096), (4090, 32, 8, 4096))}
    # phase 8's prefill shapes: whisper-tiny's encoder, non-causal over
    # its 1500 frames (a ragged last tile, every KV tile for every query
    # tile), and llava's causal prefill of its 2880-patch prefix plus
    # 1024 tokens at GQA 32/8 (the timed serve step's shape)
    fa_encvlm = {
        "B=2 S=1500 H=6 KV=6 Dh=64 non-causal": flash_times(
            2, 1500, 6, 6, 64, 0, causal=False),
        "B=2 S=3904 H=32 KV=8 Dh=128 causal": flash_times(
            2, 3904, 32, 8, 128, 0)}
    # the row bound fails a wrong kernel: the plain version with one
    # 64-key tile hidden from every query (its key positions past S)
    q, k, v = qkv(2, 4090, 32, 128, bf16, 8)
    ke, ve = expand_kv(k, 32), expand_kv(v, 32)
    pos = torch.arange(4090, device=dev)
    kpos = pos.clone()
    kpos[1024:1088] = 4090
    dropped = row_err(attend_direct(q, ke, ve, pos, kpos, causal=True,
                                    window=4096),
                      ref.flash_attention(q, k, v, window=4096))
    print(f"[check] the flash row bound {ROW_BOUND} rejects the plain "
          f"version missing one 64-key tile at B=2 S=4090 H=32 KV=8: worst "
          f"row rel_l2={dropped:.3e} {'ok' if dropped > ROW_BOUND else 'FAIL'}")
    if not dropped > ROW_BOUND:
        raise AssertionError("the flash row bound passes a dropped tile")
    del q, k, v, ke, ve

    # ring pack / unpack: bitwise against the plain version, every shape
    # of the reference's tests plus a ragged one, both wires, EF on, off
    # and on-but-None
    def flat_ef(n, s, flat_std=1.0, ef_std=1e-2):
        flat = torch.randn(n * s, generator=gen, device=dev) * flat_std
        ef = torch.randn((n, s), generator=gen, device=dev) * ef_std
        return flat, ef

    shapes = [(1, 512), (3, 1024), (5, 8192), (3, 4608), (5, 1536),
              (7, 2560), (1, 5632), (3, 1000)]
    for n, s in shapes:
        flat, ef = flat_ef(n, s)
        flat[::97] = -0.0
        for wire in ("bfloat16", "float32"):
            for mode in ("ef", "no_ef", "ef_none"):
                kw = dict(n_slices=n, slice_elems=s, wire_dtype=wire,
                          with_ef=mode != "no_ef")
                e = None if mode == "ef_none" else ef
                kw_, ke_ = ops.pack_slices(flat, e, **kw)
                out = ops.unpack_slices(kw_)
                torch.cuda.synchronize()
                rw, re = ref.pack_slices(flat, e, **kw)
                check_bitwise(f"ring_pack ({n}, {s}) {wire} {mode}",
                              [(kw_, rw), (ke_, re),
                               (out, ref.unpack_slices(rw))])

    # the main path's shape: qwen2-0.5b's capacity-clamped plan
    n, s = 64, 7_719_424
    flat, ef = flat_ef(n, s, 1e-3, 1e-6)
    kw = dict(n_slices=n, slice_elems=s, wire_dtype="bfloat16")
    wire_k, ef_k = ops.pack_slices(flat, ef, **kw)
    torch.cuda.synchronize()
    wire_r, ef_r = ref.pack_slices(flat, ef, **kw)
    pack_err = check_bitwise(
        f"ring_pack ({n}, {s}) bfloat16 ef (timed shape)",
        [(wire_k, wire_r), (ef_k, ef_r)])
    del ef_r
    un_k = ops.unpack_slices(wire_k)
    unpack_err = check_bitwise(
        f"ring_unpack ({n}, {s}) bfloat16 (timed shape)",
        [(un_k, ref.unpack_slices(wire_r))])
    nowire_k, _ = ops.pack_slices(flat, None, n_slices=n, slice_elems=s,
                                  wire_dtype="float32", with_ef=False)
    check_bitwise(f"ring_pack ({n}, {s}) float32 no_ef (timed shape)",
                  [(nowire_k, ref.pack_slices(flat, None, n_slices=n,
                                              slice_elems=s,
                                              wire_dtype="float32",
                                              with_ef=False)[0])])
    del wire_r, un_k, nowire_k
    elems = n * s

    def ring_times(kernel, plain, library, bytes_per_elem):
        """kernel, plain, library (or None), kernel again; the bound is
        the bytes over the HBM rate."""
        k1 = time_ms(kernel, iters=10, queued=True)
        p_ms = time_ms(plain, iters=5, queued=True)
        lib = None if library is None else time_ms(library, iters=10,
                                                   queued=True)
        k2 = time_ms(kernel, iters=10, queued=True)
        return {"ms": k1, "ms_again": k2, "plain_ms": p_ms,
                "library_ms": lib,
                "bound_ms": bytes_per_elem * elems / H100_BYTES_S * 1e3}

    nkw = dict(n_slices=n, slice_elems=s, wire_dtype="float32",
               with_ef=False)
    rp = {"pack_ef": ring_times(lambda: ops.pack_slices(flat, ef, **kw),
                                lambda: ref.pack_slices(flat, ef, **kw),
                                None, 14.0),
          "pack_no_ef": ring_times(
              lambda: ops.pack_slices(flat, None, **nkw),
              lambda: ref.pack_slices(flat, None, **nkw),
              lambda: flat.view(n, s).clone(), 8.0),
          "unpack": ring_times(lambda: ops.unpack_slices(wire_k),
                               lambda: ref.unpack_slices(wire_k),
                               lambda: wire_k.to(torch.float32), 6.0)}
    for name, t in rp.items():
        lib = "none (no single call)" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        print(f"[time] ring {name} ({n}, {s}): kernel {t['ms']:.4f} / "
              f"{t['ms_again']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms (bytes; "
              f"{t['bound_ms'] / t['ms']:.1%} of the HBM rate) | {smi}")
    del flat, ef, wire_k, ef_k
    torch.cuda.empty_cache()

    # WKV6: ragged shapes of every head size and rwkv6-7b's decode step;
    # every head size at ragged T and on both sides of the chunk and
    # decode-kernel boundaries (T <= DECODE_MAX_T runs the decode kernel,
    # longer T the chunked one), B*H = 6; chaining (T, then T=1 from its
    # final state, against T+1); the decode step with extreme decays, s0
    # != 0; the prefill shape with s0 != 0 and with extreme decays
    for b, t, h, hs in ((2, 37, 3, 16), (1, 100, 2, 32), (2, 33, 4, 64),
                        (2, 1, 64, 64)):
        args = wkv6_inputs(gen, b, t, h, hs)
        got = ops.wkv6(*args)
        torch.cuda.synchronize()
        want = ref.wkv6(*args)
        check_close(f"wkv6 ({b}, {t}, {h}, {hs}) y", got[0], want[0], 2e-3,
                    2e-3)
        check_close(f"wkv6 ({b}, {t}, {h}, {hs}) s_final", got[1], want[1],
                    2e-3, 2e-3)
    ch, dmax = _wk.CHUNK, _wk.DECODE_MAX_T
    wkv_ts = sorted({1, 2, dmax, dmax + 1, ch - 1, ch, ch + 1, 2 * ch + 3,
                     33, 37, 100})
    for hs in _wk.HEAD_SIZES:
        worst = 0.0
        for t in wkv_ts:
            args = wkv6_inputs(gen, 2, t, 3, hs)
            got = ops.wkv6(*args)
            torch.cuda.synchronize()
            want = ref.wkv6(*args)
            for i, part in enumerate(("y", "s_final")):
                worst = max(worst, check_close(
                    f"wkv6 (2, {t}, 3, {hs}) {part}", got[i], want[i], 2e-3,
                    2e-3, verbose=False))
        print(f"[check] wkv6 hs={hs}: B=2 H=3, T {wkv_ts}, y and s_final: "
              f"max_abs_err={worst:.3e} (atol=rtol=2e-3) ok")
    for t in (dmax, 2 * ch + 3):
        r, k, v, w, u, s0 = wkv6_inputs(gen, 2, t + 1, 64, 64)
        y1, s1 = ops.wkv6(*(x[:, :t].contiguous() for x in (r, k, v, w)), u,
                          s0)
        y2, s2 = ops.wkv6(*(x[:, t:].contiguous() for x in (r, k, v, w)), u,
                          s1)
        yw, sw = ops.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        check_close(f"wkv6 chained T={t} then 1 vs T={t + 1} y",
                    torch.cat([y1, y2], 1), yw, 2e-3, 2e-3)
        check_close(f"wkv6 chained T={t} then 1 vs T={t + 1} s_final", s2,
                    sw, 2e-3, 2e-3)
    wshape = (2, 1024, 64, 64)
    b, t, h, hs = wshape
    wkv_err = 0.0
    for shape, extreme, tol in (((b, 1, h, hs), "channels", 5e-3),
                                (wshape, None, 2e-3),
                                (wshape, "steps", 5e-3)):
        args = wkv6_inputs(gen, *shape, extreme=extreme)
        got = ops.wkv6(*args)
        torch.cuda.synchronize()
        want = ref.wkv6(*args)
        for i, part in enumerate(("y", "s_final")):
            err = check_close(f"wkv6 {shape} {part}"
                              + (f" extreme decays over {extreme}" if extreme
                                 else " (timed shape)"), got[i], want[i],
                              tol, tol)
            if shape == wshape and not extreme:
                wkv_err = max(wkv_err, err)
    args = wkv6_inputs(gen, *wshape)
    n_el = b * t * h * hs
    wkv_bound, wkv_bound_by = scan_bound_ms(
        (5 * n_el + 2 * b * h * hs * hs + h * hs) * 4.0, 5.0 * n_el * hs)
    wkv = {"ms": time_ms(lambda: ops.wkv6(*args), iters=20, queued=True),
           "plain_ms": time_ms(lambda: ref.wkv6(*args), iters=2, warmup=1,
                               queued=True, label="plain wkv6")}
    wkv["ms_again"] = time_ms(lambda: ops.wkv6(*args), iters=20, queued=True)
    dec_args = wkv6_inputs(gen, b, 1, h, hs)
    wkv["decode_ms"] = time_ms(lambda: ops.wkv6(*dec_args), iters=500,
                               queued=True)
    wkv["decode_plain_ms"] = time_ms(lambda: ref.wkv6(*dec_args), iters=100,
                                     queued=True)
    wkv["decode_ms_again"] = time_ms(lambda: ops.wkv6(*dec_args), iters=500,
                                     queued=True)
    wkv["decode_bound_ms"], _ = scan_bound_ms(
        (5 * b * h * hs + 2 * b * h * hs * hs + h * hs) * 4.0,
        5.0 * b * h * hs * hs)
    print(f"[time] wkv6 B={b} T={t} H={h} hs={hs} f32: kernel "
          f"{wkv['ms']:.4f} / {wkv['ms_again']:.4f} ms, plain "
          f"{wkv['plain_ms']:.4f} ms, library none (no single call), bound "
          f"{wkv_bound:.4f} ms ({wkv_bound_by}) | decode T=1: kernel "
          f"{wkv['decode_ms']:.5f} / {wkv['decode_ms_again']:.5f} ms, plain "
          f"{wkv['decode_plain_ms']:.4f} ms, bound "
          f"{wkv['decode_bound_ms']:.5f} ms | {smi}")
    del args, dec_args, got, want

    # RG-LRU: ragged shapes; both load paths (W % 4 == 0 and a
    # 16-byte-aligned base: TMA; any other W, or a misaligned base: 4-byte
    # cp.async) at T on both sides of the chunk; chaining (T, then T',
    # against T + T'); recurrentgemma-9b's prefill shape
    for b, t, w in ((3, 100, 65), (2, 9, 4099), (1, 1, 7)):
        args = rglru_inputs(gen, b, t, w)
        got = ops.rglru(*args)
        torch.cuda.synchronize()
        want = ref.rglru(*args)
        check_close(f"rglru ({b}, {t}, {w}) h_seq", got[0], want[0], 2e-4,
                    2e-4)
        check_close(f"rglru ({b}, {t}, {w}) h_final", got[1], want[1], 2e-4,
                    2e-4)
    lch = _rg.CHUNK
    lru_ts, lru_ws = (1, 9, lch, lch + 1, 1024), (4096, 4099, 65, 7, 4 * 1025)
    worst = 0.0
    for t in lru_ts:
        for w in lru_ws:
            args = rglru_inputs(gen, 2, t, w)
            got = ops.rglru(*args)
            torch.cuda.synchronize()
            want = ref.rglru(*args)
            for i, part in enumerate(("h_seq", "h_final")):
                worst = max(worst, check_close(
                    f"rglru (2, {t}, {w}) {part}", got[i], want[i], 2e-4,
                    2e-4, verbose=False))
    print(f"[check] rglru: B=2, T {lru_ts} x W {lru_ws}, h_seq and h_final: "
          f"max_abs_err={worst:.3e} (atol=rtol=2e-4) ok")
    a_, b_, h0 = rglru_inputs(gen, 2, lch + 1, 4096)
    buf = torch.empty(2 * a_.numel() + 1, device=dev)
    a_off = buf[1:1 + a_.numel()].view_as(a_)      # 4 bytes past alignment
    b_off = buf[1 + a_.numel():].view_as(b_)
    a_off.copy_(a_)
    b_off.copy_(b_)
    got = ops.rglru(a_off, b_off, h0)
    torch.cuda.synchronize()
    want = ref.rglru(a_, b_, h0)
    for i, part in enumerate(("h_seq", "h_final")):
        check_close(f"rglru (2, {lch + 1}, 4096) misaligned base {part}",
                    got[i], want[i], 2e-4, 2e-4)
    for t1, t2, w in ((lch, lch + 1, 4096), (9, 1, 65)):
        a_, b_, h0 = rglru_inputs(gen, 2, t1 + t2, w)
        y1, h1 = ops.rglru(a_[:, :t1].contiguous(), b_[:, :t1].contiguous(),
                           h0)
        y2, h2 = ops.rglru(a_[:, t1:].contiguous(), b_[:, t1:].contiguous(),
                           h1)
        yw, hw = ops.rglru(a_, b_, h0)
        torch.cuda.synchronize()
        check_close(f"rglru chained T={t1} then {t2} vs {t1 + t2} W={w} "
                    "h_seq", torch.cat([y1, y2], 1), yw, 2e-4, 2e-4)
        check_close(f"rglru chained T={t1} then {t2} vs {t1 + t2} W={w} "
                    "h_final", h2, hw, 2e-4, 2e-4)
    del buf, a_off, b_off
    b, t, w = 2, 1024, 4096
    args = rglru_inputs(gen, b, t, w)
    got = ops.rglru(*args)
    torch.cuda.synchronize()
    want = ref.rglru(*args)
    lru_err = max(check_close(f"rglru ({b}, {t}, {w}) {part} (timed shape)",
                              got[i], want[i], 2e-4, 2e-4)
                  for i, part in enumerate(("h_seq", "h_final")))
    lru_bound, lru_bound_by = scan_bound_ms((3 * b * t * w + 2 * b * w) * 4.0,
                                            2.0 * b * t * w)
    lru = {"ms": time_ms(lambda: ops.rglru(*args), iters=50, queued=True),
           "plain_ms": time_ms(lambda: ref.rglru(*args), iters=2, warmup=1,
                               queued=True, label="plain rglru")}
    lru["ms_again"] = time_ms(lambda: ops.rglru(*args), iters=50, queued=True)
    # the same shape through the cp.async path: a and b 4 bytes past a
    # 16-byte boundary, which no tensor map can describe
    n_ab = args[0].numel()
    buf = torch.empty(2 * n_ab + 1, device=dev)
    a_off, b_off = (buf[1 + i * n_ab:1 + (i + 1) * n_ab].view_as(args[0])
                    for i in range(2))
    a_off.copy_(args[0])
    b_off.copy_(args[1])
    assert _rg.load_path(a_off, b_off) == "cp.async" \
        and _rg.load_path(*args[:2]) == "tma"
    check_close(f"rglru ({b}, {t}, {w}) h_seq, cp.async path (timed shape)",
                ops.rglru(a_off, b_off, args[2])[0], want[0], 2e-4, 2e-4)
    lru["cp_async_ms"] = time_ms(lambda: ops.rglru(a_off, b_off, args[2]),
                                 iters=50, queued=True)
    print(f"[time] rglru B={b} T={t} W={w} f32: kernel {lru['ms']:.4f} / "
          f"{lru['ms_again']:.4f} ms (TMA path; the cp.async path "
          f"{lru['cp_async_ms']:.4f} ms), plain {lru['plain_ms']:.4f} ms, "
          f"library none (no single call), bound {lru_bound:.4f} ms "
          f"({lru_bound_by}) | {smi}")
    del args, got, want, buf, a_off, b_off

    torch.cuda.empty_cache()

    # -- 4. serve qwen2-0.5b at full width -----------------------------------
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = api.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"[init] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
          f"{cfg.param_dtype} in {time.perf_counter() - t0:.2f}s")
    serve = ServeConfig(event_loops=2, poll="busy", max_batch=2,
                        max_len=2048, comm=CommConfig(mode="gspmd",
                                                      channels=4))
    group = make_engine_group(cfg, params, serve, seed=0, device=dev)
    reqs = make_requests(cfg, 8, max_new=16, temperature=0.0, seed=0,
                         min_len=16, max_len=1025)
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    group.submit(reqs)
    results = sorted(group.run(threads=True), key=lambda r: r.uid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    prefills = sum(l.engine.prefills for l in group.loops)
    admits = sum(l.engine.admit_prefills for l in group.loops)
    n_tok = sum(len(r.tokens) for r in results)
    st = group.poll_stats()
    print(f"[serve] {len(results)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {n_tok} tokens in {dt:.3f}s "
          f"= {n_tok / dt:.1f} tok/s | prefill calls {prefills} (admission "
          f"rounds {admits}), flash launches {launches} | poll spins="
          f"{st.spins} parks={st.parks} | {smi}")
    assert [r.uid for r in results] == list(range(len(reqs)))
    assert all(len(r.tokens) == 16 for r in results), \
        [len(r.tokens) for r in results]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)
    assert admits > 0, "continuous admission did not run"
    assert launches == cfg.num_layers * prefills, (launches, prefills)

    # device time of the serve step at the path's largest shapes
    step = group.loops[0].engine.step
    big = {"tokens": torch.as_tensor(
               np.asarray(reqs[0].prompt[:16].tolist() * 64).reshape(1, -1)
               .repeat(2, 0), device=dev),
           "last_pos": torch.full((2,), 1023, device=dev)}
    ms_prefill = time_ms(lambda: step.prefill(params, big), iters=5)
    ms_prefill_plain = time_ms(
        lambda: api.prefill(params, big, cfg, attend=attend_chunked), iters=5)
    cache = api.init_cache(cfg, 2, serve.max_len, device=dev)
    dec = {"token": torch.zeros(2, dtype=torch.long, device=dev),
           "pos": torch.tensor([1023, 511], device=dev)}
    ms_decode = time_ms(lambda: step.decode(params, cache, dec), iters=10)
    print(f"[serve-time] prefill B=2 S=1024 {ms_prefill:.3f} ms (plain "
          f"attention {ms_prefill_plain:.3f} ms) | decode step B=2 cache "
          f"2048 {ms_decode:.3f} ms | {smi}")
    for what, fn, wall in (("prefill", lambda: step.prefill(params, big),
                            ms_prefill),
                           ("decode", lambda: step.decode(params, cache, dec),
                            ms_decode)):
        busy, n, ranked, by_name = profile_device(fn)
        if busy is None:
            print(f"[profile] {what}: device time not measured (the "
                  "profiler recorded no device events)")
            continue
        print(f"[profile] {what}: {n} kernels, {busy:.3f} ms on the device "
              f"of {wall:.3f} ms per step ({busy / wall:.1%} busy); top: "
              + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in ranked))
        if what == "prefill":
            check_prefill_flash(cfg.name, by_name)

    # diagnostic beside the main path: the same requests on ONE loop,
    # drained in line with parking waits (no second thread holding the
    # interpreter lock while it spins)
    solo = make_engine_group(cfg, params, ServeConfig(
        event_loops=1, poll="park", max_batch=2, max_len=2048,
        comm=CommConfig(mode="gspmd", channels=4)), seed=0, device=dev)
    t0 = time.perf_counter()
    solo.submit(reqs)
    solo_res = sorted(solo.run(threads=False), key=lambda r: r.uid)
    torch.cuda.synchronize()
    dt1 = time.perf_counter() - t0
    n1 = sum(len(r.tokens) for r in solo_res)
    print(f"[serve-diag] 1 loop inline, park: {n1} tokens in {dt1:.3f}s = "
          f"{n1 / dt1:.1f} tok/s | {smi}")

    # first-token logits of loop 0's first wave (uids 0 and 2): the
    # kernel path replays the served first tokens bit for bit
    wave = [reqs[0], reqs[2]]
    lens = np.array([len(r.prompt) for r in wave])
    toks = np.zeros((2, lens.max()), np.int64)
    for i, r in enumerate(wave):
        toks[i, :lens[i]] = r.prompt
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "last_pos": torch.as_tensor(lens - 1, device=dev)}
    lk, _ = step.prefill(params, batch)
    first = lk.argmax(-1).tolist()
    assert first == [int(results[0].tokens[0]), int(results[2].tokens[0])], \
        (first, results[0].tokens[:1], results[2].tokens[:1])
    assert lk.shape == (2, cfg.vocab_size) and bool(torch.isfinite(lk).all())

    # ... and agrees with the plain attention path. Ground truth is the
    # same weights run in f32: there the two paths differ only in the
    # order of sums. In bf16 every layer rounds activations at 2^-8, so
    # the two bf16 paths each land a few percent from the f32 logits
    # (measured on this model: 2.65e-2 apart from each other); the
    # kernel path must land no farther than twice the plain path's
    # distance. A wrong kernel misses either bound by O(1).
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    l32, _ = api.prefill(p32, batch, cfg32, attend=attend_chunked)
    lk32, _ = api.prefill(p32, batch, cfg32)
    lp, _ = api.prefill(params, batch, cfg, attend=attend_chunked)
    del p32

    e32, ek, ep = rel_l2(lk32, l32), rel_l2(lk, l32), rel_l2(lp, l32)
    logit_err = float((lk.float() - lp.float()).abs().max())
    ok = e32 <= 1e-3 and ek <= 2 * ep + 5e-3
    print(f"[check] prefill logits: f32 kernel vs plain rel_l2={e32:.3e} "
          f"(bound 1e-3); bf16 vs f32 rel_l2 kernel={ek:.3e} plain={ep:.3e} "
          f"(bound 2x plain + 5e-3); bf16 kernel vs plain max_abs_err="
          f"{logit_err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("prefill logits: kernel path disagrees with "
                             "the plain attention path")

    # -- 4b. serve qwen2-0.5b over a ring (one peer, NCCL) -------------------
    # one group for phases 4b-9: the serve ring here, the Trainers' rings
    # in phases 5 and 9 and the hadronio runs of phases 6, 7 and 8
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    ring = Ring(channels=4)
    ring_flash = serve_over_ring(
        smi, cfg, params, reqs, [tuple(r.tokens.tolist()) for r in results],
        ring, big, cache, dec)

    # -- 5. train qwen2-0.5b at full width ---------------------------------
    from repro_torch.models.common import tree_paths
    del group, solo, step, cache, params, lk, lp, l32, lk32
    torch.cuda.empty_cache()
    shape = ShapeConfig("smoke", "train", seq_len=1024, global_batch=4)

    def train_run(mode, **comm):
        return RunConfig(model=cfg, shape=shape,
                         comm=CommConfig(mode=mode, channels=4, **comm),
                         total_steps=5, warmup_steps=1, seed=0)

    main_run = train_run("hadronio", compress="bf16", pack="pallas",
                         aggregate="slice", flush="step")
    trainer = Trainer(main_run, device=dev, log_every=1)
    start = trainer.init_state()
    torch.cuda.synchronize()
    live_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for wrapper in (ops.pack_slices, ops.unpack_slices, ops.flash_attention):
        wrapper.launches = 0
    out = trainer.run_loop(start)
    torch.cuda.synchronize()
    train_launches = {w.__name__: w.launches for w in (
        ops.pack_slices, ops.unpack_slices, ops.flash_attention)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    plan = agg.make_plan(start.params, main_run.comm)
    print(f"[train] {cfg.name} hadronio/bf16/pallas, B=4 S=1024, "
          f"{plan.n_slices} slices x {plan.slice_elems} elems over 4 "
          f"channels: losses {[round(x, 4) for x in losses]}, step s "
          f"{[round(x, 4) for x in out['step_s']]}, launches "
          f"{train_launches}, max|EF| after the run "
          f"{float(out['state'].ef.abs().max()):.3e}, peak memory "
          f"{peak_gb:.2f} GB ({peak_gb - live_gb:.2f} GB above the "
          f"{live_gb:.2f} GB live before the run) | {smi}")
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert train_launches == {"pack_slices": 5, "unpack_slices": 5,
                              "flash_attention": 0}, train_launches
    assert out["state"].step == 5 and out["state"].ef.shape == (
        plan.n_slices, plan.slice_elems)

    # one real full-width gradient, synced with the kernels and without.
    # The params are bf16, so the bf16 gradient is exact on the bf16 wire
    # and its EF is zero (at ring size 1 it stays zero all run): that
    # sync holds the kernels' copy and the channel path, not their
    # rounding. So the same gradient also goes through in f32, scaled as
    # clipping scales it, with a nonzero EF of realistic size: the
    # residual of that f32 gradient's own bf16 cast.
    batch = trainer.batch(0)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                      out["state"].params)
    api.loss(leaves, batch, cfg)[0].backward()
    grads = tree_map(lambda t: t.grad, leaves)
    del leaves
    g32 = tree_map(lambda g: g.float() * 0.37, grads)
    plan32 = agg.make_plan(g32, main_run.comm, dtype=torch.float32)
    flat32 = agg.as_slices(agg.pack(g32, plan32), plan32)
    ef32 = (flat32 - flat32.to(torch.bfloat16).float()).contiguous()
    del flat32
    cases = []          # phase 5c syncs the same gradients
    for what, tree, ef_in in (("bf16 grads, run's EF", grads,
                               out["state"].ef),
                              ("f32 grads x0.37, nonzero EF", g32, ef32)):
        synced = {pack: tac.sync_grads(
            tree, dataclasses.replace(main_run.comm, pack=pack),
            ring=trainer.ring, ef=ef_in) for pack in ("pallas", "jnp")}
        torch.cuda.synchronize()
        print(f"[check] real-gradient sync ({what}): max|EF in| "
              f"{float(ef_in.abs().max()):.3e}, max|EF out| "
              f"{float(synced['pallas'].ef.abs().max()):.3e}")
        check_bitwise(f"real-gradient sync pallas vs jnp ({what}; grads, "
                      "new EF)",
                      [(a, b) for (_, a), (_, b) in zip(
                          tree_paths(synced["pallas"].grads),
                          tree_paths(synced["jnp"].grads))]
                      + [(synced["pallas"].ef, synced["jnp"].ef)])
        cases.append((what, tree, ef_in, synced["pallas"].grads))
    assert float(ef32.abs().max()) > 0 and float(
        synced["pallas"].ef.abs().max()) > 0, "the f32 sync carried no EF"
    del synced, tree, ef_in, out

    # the libvma analogue trains through the same kernels on a second
    # path: one pack and one unpack a step around ONE all-reduce
    trainer.log_every = 10
    release_memory("before the vma run (a new ring)")
    vma = Trainer(train_run("vma", compress="bf16", pack="pallas"),
                  device=dev, log_every=10)
    for wrapper in (ops.pack_slices, ops.unpack_slices):
        wrapper.launches = 0
    o = vma.run_loop(start)
    torch.cuda.synchronize()
    vma_launches = {w.__name__: w.launches for w in (ops.pack_slices,
                                                     ops.unpack_slices)}
    print(f"[train] {cfg.name} vma/bf16/pallas: losses "
          f"{[round(x, 4) for x in o['losses']]}, launches {vma_launches}")
    assert all(np.isfinite(o["losses"])) and o["losses"][-1] < o["losses"][0]
    assert vma_launches == {"pack_slices": 5, "unpack_slices": 5}, \
        vma_launches
    del o

    # -- 5c. the rest of the hadronio family ---------------------------------
    # the same real gradients through hadronio_rs, hadronio_overlap and
    # hadronio_overlap_rs (pallas vs jnp; gathered vs hadronio's tree)
    sync_family(cases, train_run, trainer.ring)
    del cases, grads, g32, ef32
    torch.cuda.empty_cache()
    # the ring kernels at the buckets' smallest and largest shapes
    from repro_torch.core.backends import hadronio_overlap as ov
    sizes = ov.make_bucket_plan(api.specs(cfg), main_run.comm).padded
    assert len(sizes) == 11, sizes       # qwen2-0.5b at 4 MiB
    bucket_times = bucket_shape_times(smi, gen, dev, (min(sizes),
                                                      max(sizes)))
    print(f"[memory] allocated before the family runs: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB (the start state "
          f"and the trainers)")
    family = train_family(smi, cfg, train_run, start, dev)
    family_launches = {k: sum(n[k] for _, n, _ in family.values())
                       for k in ("pack_slices", "unpack_slices")}

    # step time of the exchanges from one start state, in turns
    # (a b c d e e d c b a): host times drift on a machine whose CPU is
    # shared
    runs = {"hadronio/bf16/pallas": trainer,
            "hadronio/bf16/jnp": Trainer(train_run(
                "hadronio", compress="bf16", pack="jnp"), device=dev,
                log_every=10),
            "vma/bf16/pallas": vma,
            "sockets": Trainer(train_run("sockets"), device=dev,
                               log_every=10),
            "gspmd (no exchange)": Trainer(train_run("gspmd"), device=dev,
                                           log_every=10)}
    runs.update({label: t for label, (t, _, _) in family.items()})
    release_memory("before the timed runs (three new rings)")

    def state0(t, state):
        """``state`` in ``t``'s layout: as it is for the tree-moment
        modes with a ring EF; zero moments and EF around its params for
        the ZeRO-1 and bucketed modes (made per run: each holds ~6 GB)."""
        if t.run.comm.mode in ("hadronio_rs", "hadronio_overlap",
                               "hadronio_overlap_rs"):
            return steps_mod.tac_state(state.params, t.run)
        ef = get_backend(t.run.comm.mode).needs_ef(t.run.comm)
        return state if ef else state._replace(ef=None)

    samples = {label: [] for label in runs}
    for label in list(runs) + list(runs)[::-1]:
        t = runs[label]
        o = t.run_loop(state0(t, start))
        samples[label].append([x * 1e3 for x in o["step_s"][1:]])
        print(f"[train] {label}: losses {[round(x, 4) for x in o['losses']]}"
              f", step ms {[round(x * 1e3, 2) for x in o['step_s']]}")
        del o
    step_ms = {label: statistics.median(x for run in v for x in run)
               for label, v in samples.items()}
    per_run = {label: [round(statistics.median(r), 2) for r in v]
               for label, v in samples.items()}
    print("[train-time] median step ms (steps 2-5 of two runs each): "
          + ", ".join(f"{k} {v:.2f} (per run {per_run[k]})"
                      for k, v in step_ms.items()) + f" | {smi}")

    for label, t in runs.items():
        state = state0(t, start)
        busy, n_k, ranked, by_name = profile_device(
            lambda: t.step_fn(state, batch), top=8)
        del state
        wall = step_ms[label]
        if busy is None:
            print(f"[profile] train step {label}: device time not measured "
                  "(the profiler recorded no device events)")
            continue
        part = lambda key: sum(ms for name, ms in by_name.items()
                               if key(name))
        print(f"[profile] train step {label}: {n_k} kernels, {busy:.3f} ms "
              f"on the device of {wall:.3f} ms per step ({busy / wall:.1%} "
              f"busy); ring pack {part(lambda k: '::pack_kernel' in k):.3f}"
              f" ms, unpack {part(lambda k: '::unpack_kernel' in k):.3f} "
              f"ms, nccl {part(lambda k: 'nccl' in k.lower()):.3f} ms; top: "
              + "; ".join(f"{name[:100]} {ms:.3f}" for name, ms in ranked))
    for t in runs.values():     # their channel communicators go too
        t.close()
    del runs, t, vma, family
    del start, trainer

    # -- 5d. the fault-tolerant trainer ---------------------------------------
    ft_launches, ft_ckpt = train_fault_tolerant(smi, cfg, train_run, dev)

    # -- 6. serve rwkv6-7b and recurrentgemma-9b at full width ---------------
    rwkv_launches = serve_recurrent(
        gen, smi, "rwkv6-7b", (1024, 640, 384, 128), 2048,
        {"wkv6": (32, 32)}, {"scan": ref.wkv6}, ring)
    rg_cfg = get_config("recurrentgemma-9b")
    rg_lens = (2040, 1024, 384, 128)
    assert rg_lens[0] + 15 > rg_cfg.local_window   # decode wraps the window
    rg_launches = serve_recurrent(
        gen, smi, "recurrentgemma-9b", rg_lens, 4096,
        {"rglru": (26, 0), "flash_attention": (12, 0)},
        {"scan": ref.rglru, "attend": ref.flash_attention}, ring)

    # -- 7. the decoder-only families at full width --------------------------
    dense_lens = [len(r.prompt) for r in make_requests(
        get_config("qwen2-0.5b"), 8, max_new=16, temperature=0.0, seed=0,
        min_len=16, max_len=1025)]
    fam_flash = serve_decoder(gen, smi, "qwen1.5-4b", ring, lens=dense_lens)
    fam_flash += serve_decoder(gen, smi, "starcoder2-3b", ring,
                               lens=dense_lens)
    fam_flash += serve_decoder(gen, smi, "qwen1.5-110b", ring, num_layers=4)
    # pairs of equal prompts, one pair per loop and wave; mixtral's longest
    # pair decodes past its 4096-slot rolling window
    fam_flash += serve_decoder(gen, smi, "mixtral-8x7b", ring, num_layers=16,
                               lens=(4090, 1024) * 2 + (384, 128) * 2,
                               max_len=8192)
    fam_flash += serve_decoder(gen, smi, "dbrx-132b", ring, num_layers=4,
                               lens=(1024, 128) * 4)

    # -- 8. the encoder-decoder and vision-prefix families -------------------
    encvlm_flash = serve_encdec_vlm(gen, smi, "whisper-tiny", ring,
                                    dense_lens)
    encvlm_flash += serve_encdec_vlm(gen, smi, "llava-next-mistral-7b", ring,
                                     dense_lens, check_layers=4)

    # -- 9. train the families ------------------------------------------------
    fam_train = train_families(smi, dev)
    release_memory("before the card-vs-CPU losses")
    train_parity(smi, gen, dev)
    ckpt_flash = serve_from_checkpoint(smi, ft_ckpt, ring, dev)

    # -- 10. tenants and the chaos plane ---------------------------------------
    release_memory("before the tenants")
    ten_launches = serve_tenants(gen, smi)
    release_memory("before the chaos scenarios")
    chaos_flash, chaos_params, chaos_base, chaos_wall = serve_chaos(
        gen, smi, ring)

    # -- 11. the supervisor and the telemetry plane ----------------------------
    sup_flash = serve_supervised(smi, ring, chaos_params, chaos_base, dev)

    # -- 12. the two-level pod fabric ------------------------------------------
    pod_flash = serve_pods(smi, chaos_params, chaos_base, chaos_wall, dev)

    # -- 13. the analysis layer and the dry run --------------------------------
    an = analysis_phase(smi, chaos_params, ring, dev)
    del ring, chaos_params
    dist.destroy_process_group()

    # -- 14. result lines -----------------------------------------------------
    ring_src = "src/repro_torch/kernels/csrc/ring_pack.cu"
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:91",
         "launches": launches + ring_flash + rg_launches["flash_attention"]
         + fam_flash + encvlm_flash + ckpt_flash
         + ten_launches["flash_attention"] + chaos_flash + sup_flash
         + pod_flash + an["flash_attention"],
         "max_abs_err": fa64["err"],
         "ms": fa64["ms"], "plain_ms": fa64["plain_ms"],
         "bound_ms": fa64["bound_ms"], "bound_by": fa64["bound_by"],
         "library_ms": fa64["library_ms"], "dh128": {
             shape: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "err",
                                       "row_err")}
             for shape, t in fa128.items()}, "encdec_vlm": {
             shape: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "err",
                                       "row_err")}
             for shape, t in fa_encvlm.items()}},
        {"name": "pack_slices", "route": "cuda", "source": ring_src,
         "replaces": "src/repro/kernels/ring_pack.py:61",
         "launches": train_launches["pack_slices"]
         + vma_launches["pack_slices"] + family_launches["pack_slices"]
         + ft_launches["pack_slices"] + fam_train["pack_slices"]
         + an["pack_slices"],
         "max_abs_err": pack_err,
         "ms": rp["pack_ef"]["ms"], "plain_ms": rp["pack_ef"]["plain_ms"],
         "bound_ms": rp["pack_ef"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "buckets": {
             str(n): t for n, t in bucket_times["pack_slices"].items()}},
        {"name": "unpack_slices", "route": "cuda", "source": ring_src,
         "replaces": "src/repro/kernels/ring_pack.py:100",
         "launches": train_launches["unpack_slices"]
         + vma_launches["unpack_slices"] + family_launches["unpack_slices"]
         + ft_launches["unpack_slices"] + fam_train["unpack_slices"]
         + an["unpack_slices"],
         "max_abs_err": unpack_err,
         "ms": rp["unpack"]["ms"], "plain_ms": rp["unpack"]["plain_ms"],
         "bound_ms": rp["unpack"]["bound_ms"], "bound_by": "bytes",
         "library_ms": rp["unpack"]["library_ms"], "buckets": {
             str(n): t for n, t in bucket_times["unpack_slices"].items()}},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:89",
         "launches": rwkv_launches["wkv6"] + ten_launches["wkv6"],
         "max_abs_err": wkv_err,
         "ms": wkv["ms"], "plain_ms": wkv["plain_ms"], "bound_ms": wkv_bound,
         "bound_by": wkv_bound_by, "library_ms": None,
         "decode_ms": wkv["decode_ms"],
         "decode_bound_ms": wkv["decode_bound_ms"]},
        {"name": "rglru", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru.cu",
         "replaces": "src/repro/kernels/rglru.py:62",
         "launches": rg_launches["rglru"], "max_abs_err": lru_err,
         "ms": lru["ms"], "plain_ms": lru["plain_ms"], "bound_ms": lru_bound,
         "bound_by": lru_bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
