"""Where the harness finds what belongs to one cell, by name.

Everything is data or a small file of its own under the benchmark's
folder, so that a later change adds a configuration, a traffic mix, a
per-layer metric or a cell by adding files:

* ``BENCHMARK.json`` at the root of the checkout: the cells
  (``workloads``) and the metrics.
* ``configs/<config>.json``: a model configuration as it is run, which
  names its plain reference, ``reference/<name>.py``.
* ``traffic/<mix>.json``: a traffic mix's parameters; its
  ``generator`` names ``traffic/<generator>.py`` and its ``kind``
  names the runner (``serve``, ``train``).
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(rec)`` that returns a number or None;
  ``end_to_end/<metric>.py`` likewise for an end-to-end metric.
* ``limits/<workload>.json``: the limit of each number that decides a
  cell's ``correct``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple      # metric entries of BENCHMARK.json for this cell
    per_layer: tuple
    limits: dict
    bench: Path = BENCH_DIR   # where its files were found


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_config(name: str, bench: Path = BENCH_DIR) -> dict:
    return load_json(bench / "configs" / f"{name}.json")


def find_traffic(name: str, bench: Path = BENCH_DIR) -> dict:
    mix = load_json(bench / "traffic" / f"{name}.json")
    return dict(mix, name=name)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_generator(kind: str, bench: Path = BENCH_DIR):
    """The module of ``traffic/<kind>.py``."""
    return _load_module(bench / "traffic" / f"{kind}.py",
                        f"portbench_traffic_{kind}")


def find_reader(metric: str, bench: Path = BENCH_DIR) -> Callable:
    """``read`` of ``metrics/<metric>.py`` (the metric's name, dots and
    all, is the file's stem)."""
    mod = _load_module(bench / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))
    return mod.read


_REFERENCES: dict = {}


def find_reference(cfg: dict, bench: Path = BENCH_DIR):
    """The plain reference a configuration names: ``reference/<name>.py``
    (``reference`` in its file), loaded once."""
    path = bench / "reference" / f"{cfg['reference']}.py"
    if path not in _REFERENCES:
        _REFERENCES[path] = _load_module(
            path, f"portbench_reference_{cfg['reference']}")
    return _REFERENCES[path]


def find_limits(workload: str, bench: Path = BENCH_DIR) -> dict:
    return load_json(bench / "limits" / f"{workload}.json")


def find_end_to_end(metric: str, bench: Path = BENCH_DIR) -> Callable:
    """``read`` of ``end_to_end/<metric>.py``."""
    return _load_module(bench / "end_to_end" / f"{metric}.py",
                        "portbench_e2e_" + metric.replace(".", "_")).read


def _applies(metric: dict, workload: dict, cell_e2e: set) -> bool:
    if "workloads" in metric:
        return workload["name"] in metric["workloads"]
    return metric.get("moves", metric["name"]) in cell_e2e


def cell(root: Path, workload: str, bench: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json with its
    configuration, mix, metrics and limits."""
    bench = bench or BENCH_DIR
    doc = benchmark(root)
    w = [x for x in doc["workloads"] if x["name"] == workload]
    if not w:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{[x['name'] for x in doc['workloads']]}")
    w = w[0]
    e2e = tuple(m for m in doc["end_to_end"]
                if "workloads" not in m or workload in m["workloads"])
    names = {m["name"] for m in e2e}
    per = tuple(m for m in doc["per_layer"] if _applies(m, w, names))
    return Cell(name=workload, config=find_config(w["config"], bench),
                traffic=find_traffic(w["traffic"], bench),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per,
                limits=find_limits(workload, bench), bench=bench)
