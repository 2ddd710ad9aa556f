"""A copy of the benchmark at a size the CPU runs in seconds: the same
generators, readers, runners and reference, with configurations of the
same kinds (the registry entries of starcoder2-3b and mixtral-8x7b at
tiny widths, float32) and mixes of short requests. The tests drive whole
runs through it on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.spec import BENCH_DIR, find_config, find_traffic

TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 256, "torch_dtype": "float32"}

MIXES = {
    "serve_code": {"backlog": 64, "block": 4,
                   "prompt": {"law": "log_uniform", "min": 24, "max": 96,
                              "step": 1},
                   "output": {"law": "uniform", "min": 2, "max": 6},
                   "engine": {"max_batch": 4, "max_len": 128,
                              "event_loops": 1, "poll": "busy"},
                   "check": {"tokens": 24}},
    "serve_offline": {"backlog": 64, "block": 4,
                      "prompt": {"law": "log_uniform", "min": 16, "max": 64,
                                 "step": 16},
                      "output": {"law": "uniform", "min": 3, "max": 8},
                      "engine": {"max_batch": 2, "max_len": 80,
                                 "event_loops": 1, "poll": "busy"},
                      "check": {"tokens": 24}},
    "train_hadronio": {"global_batch": 4, "seq_len": 32, "microbatches": 2},
}

CELLS = {"starcoder2-3b-15L.serve_code": ("starcoder2-3b-15L", "serve_code"),
         "mixtral-8x7b-16L.serve_offline": ("mixtral-8x7b-16L",
                                            "serve_offline"),
         "starcoder2-3b-15L.train_hadronio": ("starcoder2-3b-15L",
                                              "train_hadronio")}


def make(tmp: Path, limits=None) -> tuple:
    """(root, bench) of a tiny copy under ``tmp``: ``bench`` holds the
    benchmark's code and data files with the configurations and mixes
    cut down, ``root`` its BENCHMARK.json."""
    bench = tmp / "bench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("starcoder2-3b-15L", "mixtral-8x7b-16L"):
        cfg = dict(find_config(name), **TINY)
        if "num_local_experts" in cfg:
            cfg.update(num_local_experts=4, intermediate_size=96)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, over in MIXES.items():
        mix = find_traffic(name)
        mix.pop("name")
        mix.update(over)
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, lim in (limits or {}).items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    doc = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp, bench
