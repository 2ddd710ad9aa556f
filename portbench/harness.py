"""The benchmark's entry: one run of one cell.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The cell's configuration,
traffic mix, metrics and limits are found by name (``spec.py``); the
mix's ``kind`` picks the runner (``serve.py``, ``train.py``). With
``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy and traced
seconds and a breakdown. Every run checks what its timed path produced
against the plain reference and prints each number compared beside its
limit, as the last lines of standard error and as the last key of the
result line, which is the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from portbench import program, spec

RUNNERS = {"serve": "portbench.serve", "train": "portbench.train"}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics_of(cell: spec.Cell, rec: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or its per-layer ones
    (traced), each from the reader found by its name; a reader that
    finds nothing leaves its metric out."""
    out = {}
    if trace:
        for m in cell.per_layer:
            v = spec.find_reader(m["name"], cell.bench)(rec)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in cell.end_to_end:
        v = spec.find_end_to_end(m["name"], cell.bench)(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def verdict(checks: dict, failed: int) -> bool:
    return failed == 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())


def result_line(cell, out: dict, trace: bool, device) -> dict:
    import torch
    from portbench import devtrace
    rec = dict(out["record"], setup_s=out["setup_s"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["peak"]}
    line = {"correct": verdict(out["checks"], out["failed"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics_of(cell, rec, trace), "device": dev}
    win = rec["win"]
    if trace and win.window_s is not None:
        dev["busy_s"] = devtrace.busy_s(win)
        dev["window_s"] = win.window_s
        line["breakdown"] = devtrace.breakdown(win, rec["spans"])
        for name, s, n in devtrace.by_name(win)[:40]:
            print(f"[trace] {s * 1e3:10.3f} ms {n:6d}x {name[:160]}",
                  file=sys.stderr)
    line["checks"] = out["checks"]
    return line


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_process: float,
             bench: Path = spec.BENCH_DIR) -> dict:
    """One run of ``workload`` on ``device``; returns the result line.
    ``bench`` is where the cell's files are (the tests run copies)."""
    import importlib
    import time
    print(f"[setup] process start to the harness (interpreter, torch): "
          f"{time.perf_counter() - t_process:.2f} s", file=sys.stderr)
    cell = spec.cell(root, workload, bench)
    runner = importlib.import_module(RUNNERS[cell.traffic["kind"]])
    out = runner.run(cell, seed, seconds, trace, device, t_process)
    return result_line(cell, out, trace, device)


def main(argv, t_process: float) -> int:
    args = parse(argv)
    root = spec.BENCH_DIR.parent
    program.add_src(root)
    import time
    import torch
    t_torch = time.perf_counter()
    cell = spec.cell(root, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s), "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[setup] the interpreter and torch's import {t_torch - t_process:.2f}"
          f" s, the CUDA driver's start {time.perf_counter() - t_torch:.2f} s",
          file=sys.stderr)
    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0), t_process)
    bad = program.forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
