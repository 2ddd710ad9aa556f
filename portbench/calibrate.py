"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 --seconds 10

For each of ``--seeds`` seeds, one run of the cell as the benchmark
makes it (set-up, a window of ``--seconds`` at the cell's own load, the
check) gives the program's reading of each number compared. On the
first ``--controls`` seeds the same numbers are read for the control,
the plain reference in float8 e4m3 put in the program's place, and, in
a training cell, for faults planted in the reference put in the
program's place (half of each batch left out and the mean taken over
the rest; the exchange's result lost, so that the optimizer gets zeros),
both at the start and in the step after the window. A state left
unchanged reads 1 by construction (its change is nought) and needs no
run. One JSON line per seed, then a summary (each number's largest
program reading and each control's or fault's smallest)."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import program, spec  # noqa: E402


def serve_readings(serve, state: dict):
    """Wrap ``serve.reference_gaps`` so that it notes every statistic of
    the program's gaps, and on the control's seeds reads the control at
    the same positions: the f32 reference's gap of the token that
    float8 puts first."""
    orig = serve.reference_gaps

    def reference_gaps(cell, flat, seqs):
        gaps = orig(cell, flat, seqs)
        state["program_all"] = {n: fn(gaps)
                                for n, fn in serve.GAP_STATS.items()}
        if state.get("with_control"):
            ref = spec.find_reference(cell.config, cell.bench)
            f32 = ref.served_logits(flat, cell.config, seqs)
            q = ref.served_logits(flat, cell.config, seqs, "fp8")
            ctl = serve.logit_gaps(f32, seqs, pick=q)
            state["control"] = {n: fn(ctl)
                                for n, fn in serve.GAP_STATS.items()}
            state["control_quantiles"] = [float(x) for x in np.quantile(
                np.concatenate(ctl), [0.5, 0.75, 0.9, 0.99])]
        return gaps
    serve.reference_gaps = reference_gaps


def train_readings(train, state: dict):
    """Wrap ``train.check`` so that, on the control's seeds, the same
    numbers are read for the control and the planted faults, at the
    start (from the seed) and at the end (from the window's state)."""
    orig, orig_compare = train.check, train.compare

    def compare(prog, refd):
        # every leaf's norms, kept with the seed's row (start, then end)
        state.setdefault("leaves", []).append(
            {k: {"prog": prog[k], "ref": refd[k]} for k in ("grad", "change")})
        return orig_compare(prog, refd)

    def check(cell, seed, device, batch, start, after):
        train.compare = compare
        try:
            out = orig(cell, seed, device, batch, start, after)
        finally:
            train.compare = orig_compare
        if not state.get("with_control"):
            return out
        half = lambda i: {k: v[: v.shape[0] // 2]
                          for k, v in batch(i).items()}
        runs = {
            "": lambda b, p="f32": train.reference(cell, seed, device, b, p),
            "last_": lambda b, p="f32": train.reference_after(
                cell, device, b, after, p)}
        faults = {}
        for label, run in runs.items():
            base = run(batch)
            got = {"control": run(batch, "fp8"), "half_batch": run(half),
                   "exchange_lost": gradients_lost(cell, lambda: run(batch))}
            for f, r in got.items():
                faults.setdefault(f, {}).update(
                    {label + n: v for n, v in train.compare(r, base).items()
                     if "_gap" in n})
                state.setdefault("fault_leaves", {}).setdefault(f, {})[
                    label or "start"] = {"grad": {"prog": r["grad"],
                                                  "ref": base["grad"]}}
        state["faults"] = faults
        return out
    train.check = check


def gradients_lost(cell, run) -> dict:
    """``run`` of the reference with every gradient replaced by zeros
    before the optimizer: what a step reads when the exchange's result
    never arrives."""
    import torch
    ref = spec.find_reference(cell.config, cell.bench)
    orig = ref.loss
    try:
        ref.loss = lambda W, tk, lb, cfg, precision="f32": sum(
            (t * 0).sum() for t in W.values()) + orig(W, tk, lb, cfg,
                                                      precision).detach()
        return run()
    finally:
        ref.loss = orig
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def overridden(workload: str, over: dict, mix_over: dict) -> tuple:
    """(root, bench) of a copy of the benchmark in which the cell's
    configuration has the keys of ``over`` changed, and its mix those
    of ``mix_over``."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp())
    bench = tmp / "bench"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.BENCH_DIR.parent / "BENCHMARK.json", tmp)
    w = [w for w in spec.benchmark(tmp)["workloads"]
         if w["name"] == workload][0]
    for path, keys in ((bench / "configs" / f"{w['config']}.json", over),
                       (bench / "traffic" / f"{w['traffic']}.json", mix_over)):
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **keys)))
    return tmp, bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default="",
                   help="JSON of configuration keys to change, in a copy "
                        "of the benchmark under TMPDIR (a witness at "
                        "another size or precision)")
    p.add_argument("--mix-override", default="",
                   help="JSON of the traffic mix's keys to change, likewise")
    args = p.parse_args(argv)
    root = spec.BENCH_DIR.parent
    program.add_src(root)
    bench = spec.BENCH_DIR
    if args.override or args.mix_override:
        root, bench = overridden(args.workload,
                                 json.loads(args.override or "{}"),
                                 json.loads(args.mix_override or "{}"))
    import torch
    from portbench import harness, serve, train
    state: dict = {}
    kind = spec.cell(root, args.workload, bench).traffic["kind"]
    if kind == "serve":
        serve_readings(serve, state)
    else:
        train_readings(train, state)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        state.clear()
        state["with_control"] = i < args.controls
        t = time.perf_counter()
        line = harness.run_cell(root, args.workload, seed, args.seconds,
                                False, torch.device(args.device), t, bench)
        row = {"seed": seed, "correct": line["correct"],
               "program": {k: v["value"] for k, v in line["checks"].items()},
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "wall_s": time.perf_counter() - t}
        for k in ("control", "control_quantiles", "faults", "program_all",
                  "leaves", "fault_leaves"):
            if k in state:
                row[k] = state[k]
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary: dict = {}
    for r in rows:
        for n, v in dict(r.get("program_all", {}), **r["program"]).items():
            s = summary.setdefault(n, {})
            s["program_max"] = max(s.get("program_max", v), v)
    for r in rows:
        faults = r.get("faults", {"control": r["control"]}
                       if "control" in r else {})
        for f, got in faults.items():
            for n, v in got.items():
                s = summary.setdefault(n, {})
                s[f + "_min"] = min(s.get(f + "_min", v), v)
    print("[calibrate] " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
