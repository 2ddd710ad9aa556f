#!/usr/bin/env python3
"""Time builds of the WKV6 and RG-LRU kernels against each other on one
card.

  python3 tools/scan_ab.py src/repro_torch/kernels/csrc artifacts/old \\
      "src/repro_torch/kernels/csrc:rwkv6_scan.CH=32"

Each argument is one build: a directory that holds ``rwkv6_scan.cu`` and
``rglru.cu`` (C entries ``wkv6_fwd`` and ``rglru_fwd``) and the headers
they include, optionally followed by ``:NAME=VALUE,...``, which rewrites
the lines ``constexpr int NAME = ...;`` of both files in a copy
(``rglru.NAME`` or ``rwkv6_scan.NAME`` rewrites one file only); any other
variant, such as another state tile, is an edited copy of the directory.
Every build is compiled with the port's nvcc flags (a spill fails), held
against the plain versions with chip_smoke.py's inputs and checks (WKV6
at 2e-3, 5e-3 at extreme decays; RG-LRU at 2e-4), then timed at the main
paths' shapes in turns (a b ... b a) by chip_smoke.py's queued
``time_ms``; RG-LRU also with a and b 4 bytes past a 16-byte boundary
(the cp.async path). Needs a card; exits non-zero if a build fails or
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
                                ".."))

from chip_smoke import (check_close, rglru_inputs, spill_lines,  # noqa: E402
                        time_ms, wkv6_inputs)
from repro_torch.kernels import build, ref  # noqa: E402

WKV = (2, 1024, 64, 64)      # rwkv6-7b prefill: B, T, H, hs
WKV_DEC = (2, 1, 64, 64)     # its decode step
LRU = (2, 1024, 4096)        # recurrentgemma-9b prefill: B, T, W


def compile_lib(spec: str, name: str, workdir: str, tag: str):
    """The library of ``name``.cu in the spec's directory, its constants
    rewritten as the spec says; exits on a failed build or a spill."""
    path, _, sets = spec.partition(":")
    src = open(os.path.join(path, f"{name}.cu")).read()
    for part in filter(None, sets.split(",")):
        key, val = part.split("=")
        only, _, key = key.rpartition(".")
        if not only or only == name:
            src = re.sub(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
    cu, so = (os.path.join(workdir, f"{tag}{ext}") for ext in (".cu", ".so"))
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", path,
                           "-o", so, cu], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode or spill_lines(log):
        raise SystemExit(f"build {spec} {name} failed or spills:\n"
                         f"{log[-4000:]}")
    return ctypes.CDLL(so)


def bind(lib, entry: str, n_ptr: int, n_int: int):
    """The C entry as a function of tensors: the first outputs are
    ``empty_like`` the first input and the last."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(*xs):
        outs = torch.empty_like(xs[0]), torch.empty_like(xs[-1])
        err = fn(*(x.data_ptr() for x in xs + outs), *xs[0].shape,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry} launch failed: {err}")
        return outs
    return run


def main(specs) -> int:
    if not torch.cuda.is_available():
        print("scan_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as work:
        runs = {spec: (bind(compile_lib(spec, "rwkv6_scan", work, f"w{i}"),
                            "wkv6_fwd", 8, 4),
                       bind(compile_lib(spec, "rglru", work, f"l{i}"),
                            "rglru_fwd", 5, 3))
                for i, spec in enumerate(specs)}
        for spec, (run_wkv, run_lru) in runs.items():
            worst = 0.0
            for hs in (16, 32, 64):
                for t in (1, 2, 4, 5, 15, 16, 17, 33, 35, 100):
                    for extreme in (None, "steps", "channels"):
                        args = wkv6_inputs(gen, 2, t, 3, hs, extreme)
                        tol = 5e-3 if extreme else 2e-3
                        for g, w in zip(run_wkv(*args), ref.wkv6(*args)):
                            worst = max(worst, check_close(
                                f"{spec} wkv6 hs={hs} T={t} {extreme}", g, w,
                                tol, tol, verbose=False))
            for t in (1, 9, 32, 33, 100):
                for w in (4096, 4099, 65, 7, 4100):
                    args = rglru_inputs(gen, 2, t, w)
                    for g, want in zip(run_lru(*args), ref.rglru(*args)):
                        worst = max(worst, check_close(
                            f"{spec} rglru T={t} W={w}", g, want, 2e-4, 2e-4,
                            verbose=False))
            print(f"[check] {spec}: wkv6 90 cases, rglru 25 cases, "
                  f"max_abs_err={worst:.3e}")
        wkv_args, dec_args = wkv6_inputs(gen, *WKV), wkv6_inputs(gen, *WKV_DEC)
        lru_args = rglru_inputs(gen, *LRU)
        n_ab = lru_args[0].numel()
        buf = torch.empty(2 * n_ab + 1, device="cuda")
        lru_off = tuple(buf[1 + i * n_ab:1 + (i + 1) * n_ab].view(LRU)
                        for i in range(2)) + lru_args[2:]
        lru_off[0].copy_(lru_args[0])
        lru_off[1].copy_(lru_args[1])
        cases = {"wkv6 prefill": (0, wkv_args, 20),
                 "wkv6 decode": (0, dec_args, 500),
                 "rglru": (1, lru_args, 50),
                 "rglru misaligned base": (1, lru_off, 50)}
        times = {spec: {c: [] for c in cases} for spec in runs}
        for spec in list(runs) + list(runs)[::-1]:
            for case, (i, args, iters) in cases.items():
                times[spec][case].append(time_ms(
                    lambda: runs[spec][i](*args), iters=iters, queued=True,
                    label=f"{spec} {case}"))
        for spec, t in times.items():
            print(f"[time] {spec} (wkv6 {WKV}, decode {WKV_DEC}, rglru {LRU})"
                  + "".join(f"; {c} " + "/".join(f"{x:.5f}" for x in ms)
                            + " ms" for c, ms in t.items()) + f" | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(build.CSRC)]))
