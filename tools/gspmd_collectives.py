#!/usr/bin/env python3
"""The GSPMD cells' collective schedules side by side: the port's dry run
(DTensor's propagation on a fake process group) against the JAX
reference's lowered StableHLO, per cell of one architecture.

  PYTHONPATH=src python3 tools/gspmd_collectives.py \
      [--arch qwen2-0.5b-reduced] [--shapes train_4k prefill_32k decode_32k]

Runs on the CPU of a machine with both packages (the reference needs
JAX; never the card's machine). Each port cell is ``python -m
repro_torch.launch.dryrun --mode gspmd`` in a subprocess of its own; the
reference's cells are ``repro.launch.dryrun._lower_cell`` in one JAX
subprocess (its import forces 512 host devices), lowered and compiled,
read with ``collective_stats`` from the compiled module, as the
reference's own dry run records them (its lowered StableHLO carries
sharding annotations and no collective: GSPMD partitions at compile
time; a scanned layer loop's collectives appear once in that text).
Prints one line per cell and kind: the op count and result bytes of
each. The two are not meant to agree: XLA's partitioner and combiners
choose other collectives than DTensor's per-op redistributions. Use
``-reduced`` archs here: a full-width reference compile is large.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX = textwrap.dedent('''
    import json, sys
    from repro import compat
    from repro.configs.registry import get_config, get_shape
    from repro.launch import dryrun, hlo_analysis as hlo
    from repro.launch.mesh import make_production_mesh

    arch, out, shapes = sys.argv[1], sys.argv[2], sys.argv[3:]
    mesh = make_production_mesh(multi_pod=False)
    res = {}
    with compat.set_mesh(mesh):
        for shape in shapes:
            low = dryrun._lower_cell(get_config(arch), get_shape(shape), mesh,
                                     "gspmd", 1)
            res[shape] = hlo.collective_stats(
                low.compile().as_text()).as_dict()
    with open(out, "w") as f:
        json.dump(res, f)
''')


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen2-0.5b-reduced")
    p.add_argument("--shapes", nargs="+",
                   default=["train_4k", "prefill_32k", "decode_32k"])
    args = p.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             args.arch, "--shape", shape, "--mode", "gspmd", "--out", tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for shape in args.shapes]
        jax_out = os.path.join(tmp, "reference.json")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _JAX, args.arch, jax_out, *args.shapes],
            env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        for proc in procs:
            log = proc.communicate()[0]
            if proc.returncode:
                print(log[-3000:], file=sys.stderr)
                return 1
        from repro_torch.launch import dryrun
        with open(jax_out) as f:
            ref = json.load(f)
        for shape in args.shapes:
            with open(dryrun.artifact_path(args.arch, shape, "pod", "gspmd",
                                           tmp)) as f:
                port = json.load(f)["collectives"]
            kinds = sorted(set(port["counts"]) | set(ref[shape]["counts"]))
            for kind in kinds:
                print(f"{args.arch} {shape} {kind}: port "
                      f"{port['counts'].get(kind, 0)} ops "
                      f"{port['bytes'].get(kind, 0)} B, reference "
                      f"{ref[shape]['counts'].get(kind, 0)} ops "
                      f"{ref[shape]['bytes'].get(kind, 0)} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
