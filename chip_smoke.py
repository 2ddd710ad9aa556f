#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases, one line each; any failed check raises and the script exits
non-zero (no phase's failure is caught):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   TF32 switched off for f32 products;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and report the seconds;
3. hold each kernel against its plain PyTorch version on the card at
   the stated tolerances, then time kernel, plain version and the one
   PyTorch library call that computes the same function, at the serving
   path's largest prefill shape, beside the roofline bound;
4. serve qwen2-0.5b at full width (random weights from a seed) through
   ``make_engine_group`` -> ``EventLoopGroup`` -> ``DecodeEngine`` ->
   ``dispatch.ServeStep``: 8 requests, prompts of 16..1024 tokens, 16
   new tokens each, 2 decode slots per loop (so continuous admission
   runs), 2 event loops, busy polling, greedy. Checks every request's
   token count, that every prefill went through the kernel (launch
   counter), that served first tokens replay from the kernel-path
   logits, and that those logits match the plain-attention path;
5. the ``kernels`` JSON line, then the final ``ok`` JSON line.

Exits non-zero without a result when CUDA is not available.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
H100_BYTES_S = 3.35e12       # HBM3


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, top: int = 6):
    """Kernel time of one ``fn`` call from the profiler's device trace:
    (summed kernel ms, kernel count, [(name, ms)] of the ``top`` kernel
    names by time). An empty trace returns (None, 0, [])."""
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
        return None, 0, []
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), n, ranked


def attn_bound_ms(b, s, h, dh, causal, window, elem_bytes, peak_flops):
    """Least time for one attention call: the larger of its FLOPs (two
    products over the (q, k) pairs the masks keep) over the peak rate and
    its bytes (q, k, v read once, o written once) over the memory rate."""
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= (q - k) < window
    flops = 4.0 * b * h * dh * int(keep.sum())
    nbytes = 4.0 * b * s * h * dh * elem_bytes
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def check_close(name, got, want, atol, rtol) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_err = float(err.max())
    ok = bool(torch.isfinite(got).all()) and worst <= atol
    print(f"[check] {name}: max_abs_err={max_err:.3e} "
          f"(atol={atol}, rtol={rtol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import api
    from repro_torch.models.attention import attend_chunked
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

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.load("flash_attention")
    info = build.BUILD_INFO["flash_attention"]
    print(f"[build] flash_attention: {time.perf_counter() - t0:.2f}s "
          f"(nvcc {info['seconds']:.2f}s) -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    # -- 3. kernel vs plain version ----------------------------------------
    def qkv(b, s, h, dh, dtype):
        return [torch.randn((b, s, h, dh), generator=gen, device=dev)
                .to(dtype) for _ in range(3)]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, dtype, B, S, H, Dh, causal, window, atol, rtol
        ("bf16 causal S=32", bf16, 4, 32, 14, 64, True, 0, 3e-2, 5e-2),
        ("bf16 causal S=257", bf16, 4, 257, 14, 64, True, 0, 3e-2, 5e-2),
        ("bf16 causal S=1024", bf16, 4, 1024, 14, 64, True, 0, 3e-2, 5e-2),
        ("bf16 window=48 S=257", bf16, 4, 257, 14, 64, True, 48, 3e-2, 5e-2),
        ("bf16 non-causal S=257", bf16, 4, 257, 14, 64, False, 0, 3e-2, 5e-2),
        ("f32 Dh=16 S=257", f32, 2, 257, 3, 16, True, 0, 2e-4, 2e-3),
        ("f32 Dh=128 S=257", f32, 2, 257, 3, 128, True, 0, 2e-4, 2e-3),
        ("f32 Dh=32 window=48 S=200", f32, 2, 200, 3, 32, True, 48, 2e-4, 2e-3),
        ("f32 Dh=64 non-causal S=100", f32, 1, 100, 2, 64, False, 0, 2e-4,
         2e-3),
    ]
    for name, dt, b, s, h, dh, causal, window, atol, rtol in cases:
        q, k, v = qkv(b, s, h, dh, dt)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check_close(name, got, ref.flash_attention(q, k, v, causal=causal,
                                                   window=window), atol, rtol)

    # timing at the serving path's largest prefill: 2 rows x 1024 tokens
    b, s, h, dh = 2, 1024, 14, 64
    q, k, v = qkv(b, s, h, dh, bf16)
    fa_err = check_close("bf16 causal B=2 S=1024 (timed shape)",
                         ops.flash_attention(q, k, v),
                         ref.flash_attention(q, k, v), 3e-2, 5e-2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms_kernel = time_ms(lambda: ops.flash_attention(q, k, v))
    ms_plain = time_ms(lambda: ref.flash_attention(q, k, v), iters=5)
    ms_lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    ms_kernel2 = time_ms(lambda: ops.flash_attention(q, k, v))
    bound, bound_by = attn_bound_ms(b, s, h, dh, True, 0, 2, H100_BF16_FLOPS)
    fma_bound, _ = attn_bound_ms(b, s, h, dh, True, 0, 2, H100_F32_FLOPS)
    print(f"[time] flash_attention B={b} S={s} H={h} Dh={dh} bf16 causal: "
          f"kernel {ms_kernel:.4f} / {ms_kernel2:.4f} ms, plain "
          f"{ms_plain:.4f} ms, sdpa {ms_lib:.4f} ms, bound {bound:.4f} ms "
          f"({bound_by}; f32-FMA bound {fma_bound:.4f} ms) | {smi}")

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
        busy, n, ranked = profile_device(fn)
        if busy is None:
            print(f"[profile] {what}: device time not measured (the "
                  "profiler recorded no device events)")
            continue
        print(f"[profile] {what}: {n} kernels, {busy:.3f} ms on the device "
              f"of {wall:.3f} ms per step ({busy / wall:.1%} busy); top: "
              + "; ".join(f"{name[:48]} {ms:.3f}" for name, ms in ranked))

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

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    e32, ek, ep = rel(lk32, l32), rel(lk, l32), rel(lp, l32)
    logit_err = float((lk.float() - lp.float()).abs().max())
    ok = e32 <= 1e-3 and ek <= 2 * ep + 5e-3
    print(f"[check] prefill logits: f32 kernel vs plain rel_l2={e32:.3e} "
          f"(bound 1e-3); bf16 vs f32 rel_l2 kernel={ek:.3e} plain={ep:.3e} "
          f"(bound 2x plain + 5e-3); bf16 kernel vs plain max_abs_err="
          f"{logit_err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("prefill logits: kernel path disagrees with "
                             "the plain attention path")

    # -- 5. result lines ----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": launches, "max_abs_err": fa_err,
        "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": ms_lib}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
