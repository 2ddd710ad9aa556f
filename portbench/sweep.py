"""The knee of an open-loop serving cell: the highest rate it sustains.

    python3 portbench/sweep.py --workload <cell> --rates 8,12,16,20 \
        --seconds 20

One set-up, then one window per rate, the cell's mix at that rate and
nothing else changed. Per rate: the first-token times' median and 95th
percentile over every request due, the share of requests finished
within the window, and the first-token time of the last fifth of the
requests against the first fifth: a queue that grows all through the
window shows as a last fifth far behind. A rate is sustained while
nothing grows; the cell's rate is written into its mix at about four
fifths of the highest sustained one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import program, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1_234_567_891)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = spec.BENCH_DIR.parent
    program.add_src(root)
    import numpy as np
    import torch
    import torch.distributed as dist
    from portbench import serve
    cell = spec.cell(root, args.workload)
    dev = torch.device(args.device)
    st = serve.setup(cell, args.seed, dev, False)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            mix = dict(cell.traffic, rate_per_s=rate)
            rec = serve.window(st, cell, args.seed, args.seconds, False, dev,
                               mix)
            reqs = rec["requests"]
            ttft = np.array([r.first - r.due_abs for r in reqs])
            fifth = max(1, len(reqs) // 5)
            done_in = sum(1 for r in reqs if r.done is not None
                          and r.done <= rec["t_end"])
            print(json.dumps({
                "rate_per_s": rate, "requests": len(reqs),
                "ttft_p50_ms": float(np.median(ttft)) * 1e3,
                "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
                "first_fifth_p50_ms": float(np.median(ttft[:fifth])) * 1e3,
                "last_fifth_p50_ms": float(np.median(ttft[-fifth:])) * 1e3,
                "finished_in_window": done_in / len(reqs),
                "drain_s": rec["t_drained"] - rec["t_end"],
                "rows_per_decode_step": rec["decode_tokens"]
                / max(1, rec["counters"][2])}), flush=True)
    finally:
        st["ring"].close()
        if st["own_group"] and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
