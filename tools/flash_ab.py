#!/usr/bin/env python3
"""Time tile tables of the bf16 flash-attention kernel against each other
on one card.

  python3 tools/flash_ab.py base "64=64,1;256=64,1" "64=128,2"

Each argument after the script is one build of
``src/repro_torch/kernels/csrc/flash_attention.cu``: ``base`` is the file as
it is; ``Dh=BK,NWG[;Dh=...]`` rewrites those head dims' ``Tile`` lines
(KV rows per tile, 64 or 128, the S products the source has; warpgroups
per block, 1 or 2; within the 227 KB a block may use) in a copy. Every
build is compiled with the port's nvcc flags, held against the plain
version on 180 small cases (every head dim, KV heads 1/2/4, S 1/63/65/257,
causal / window 48 / non-causal, at 3e-2/5e-2), then timed at the main
paths' prefill shapes in turns (a b c ... c b a), with SDPA on expanded
heads beside them. Needs a card; exits non-zero if a build fails or
disagrees.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.models.attention import expand_kv  # noqa: E402

SHAPES = [  # B, S, H, KV, Dh, window: the main paths' prefill shapes
    (2, 1024, 14, 2, 64, 0), (2, 1024, 14, 14, 64, 0),
    (2, 1024, 16, 1, 256, 2048), (2, 1024, 16, 16, 256, 2048)]


def source(spec: str) -> str:
    src = (build.CSRC / "flash_attention.cu").read_text()
    if spec == "base":
        return src
    for part in spec.split(";"):
        dh, cfg = part.split("=")
        line = re.compile(
            rf"template <> struct Tile<{dh}> : TileOf<[^>]*> {{}};")
        assert line.search(src), f"no Tile<{dh}> line"
        src = line.sub(f"template <> struct Tile<{dh}> : TileOf<{cfg}> {{}};",
                       src)
    return src


def compile_entry(src: str, workdir: str, i: int):
    cu = os.path.join(workdir, f"flash_{i}.cu")
    so = os.path.join(workdir, f"flash_{i}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise SystemExit(f"build {i} failed:\n{log[-4000:]}")
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"[1-9]\d* bytes spill", log)
    fn = ctypes.CDLL(so).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs, spills


def run(fn, q, k, v, causal=True, window=0):
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
             h, k.shape[2], dh, 1, int(causal), window, s,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def time_ms(f, iters=30, warmup=3):
    """Device time per call, the calls queued behind a device-side spin so
    the host's launch cost does not show."""
    for _ in range(warmup):
        f()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(iters):
        f()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / iters


def main(specs) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    fns = {}
    with tempfile.TemporaryDirectory() as work:
        for i, spec in enumerate(specs):
            fns[spec], regs, spills = compile_entry(source(spec), work, i)
            print(f"[build] {spec}: registers {regs}, spills {spills or 0}")
            if spills:
                return 1
        bad = 0
        for spec, fn in fns.items():
            worst = 0.0
            for dh in (16, 32, 64, 128, 256):
                for kv in (1, 2, 4):
                    for s in (1, 63, 65, 257):
                        for causal, window in ((True, 0), (True, 48),
                                               (False, 0)):
                            q, k, v = rnd(2, s, 4, dh), rnd(2, s, kv, dh), \
                                rnd(2, s, kv, dh)
                            got = run(fn, q, k, v, causal, window).float()
                            want = ref.flash_attention(
                                q, k, v, causal=causal, window=window).float()
                            err = (got - want).abs()
                            if not (bool(torch.isfinite(got).all()) and float(
                                    (err - 5e-2 * want.abs()).max()) <= 3e-2):
                                bad += 1
                                print(f"[check] {spec} FAIL Dh={dh} KV={kv} "
                                      f"S={s} causal={causal} window={window}")
                            worst = max(worst, float(err.max()))
            print(f"[check] {spec}: 180 cases, max_abs_err={worst:.3e}")
        if bad:
            return 1
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for b, s, h, kv, dh, window in SHAPES:
            q, k, v = rnd(b, s, h, dh), rnd(b, s, kv, dh), rnd(b, s, kv, dh)
            qt, kt, vt = (x.transpose(1, 2).contiguous()
                          for x in (q, expand_kv(k, h), expand_kv(v, h)))
            times = {spec: [] for spec in fns}
            for spec in list(fns) + list(fns)[::-1]:
                times[spec].append(time_ms(
                    lambda: run(fns[spec], q, k, v, True, window)))
            lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
            print(f"[time] B={b} S={s} H={h} KV={kv} Dh={dh} window {window}: "
                  + ", ".join(f"{spec} {min(t):.4f}/{max(t):.4f} ms"
                              for spec, t in times.items())
                  + f", sdpa {lib:.4f} ms | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["base"]))
