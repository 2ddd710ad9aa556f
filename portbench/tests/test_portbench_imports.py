"""Nothing the benchmark runs loads JAX, the JAX package or its
benchmark folder: top-level module names are compared whole, since the
port's name ``repro_torch`` begins with the JAX package's ``repro``."""
import json
import os
import subprocess
import sys

from portbench import program, spec

ROOT = spec.BENCH_DIR.parent


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", sys)
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    bad = program.forbidden_modules()
    assert not any(m.startswith(("repro_torch", "reprox", "jaxlike"))
                   for m in bad)
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in program.forbidden_modules()


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny cell run end to end on the CPU in a fresh process, with
    the port loaded as the card's run loads it."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
from portbench import harness, program
from portbench.tests import tiny
from pathlib import Path
root, bench = tiny.make(Path({str(tmp_path)!r}))
line = harness.run_cell(root, "starcoder2-3b-15L.serve_code", 5, 3.0, False,
                        torch.device("cpu"), time.perf_counter(), bench)
print(json.dumps({{"bad": program.forbidden_modules(),
                   "correct": line["correct"]}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["correct"]


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run exits with an error and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "starcoder2-3b-15L.serve_code", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env=env, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
