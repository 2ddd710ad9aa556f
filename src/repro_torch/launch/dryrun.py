"""The dry run: one cell's train step traced on a fake process group.

Counterpart of ``repro/launch/dryrun.py``. For an (architecture x input
shape x mesh) cell the reference lowers and compiles the step on 256 or
512 forced host devices and records the compiled program's memory,
cost and collective analysis. Here the process is peer 0 of a
``"fake"`` process group of the mesh's size (256, or 512 in 2 pods):
``launch/mesh.make_ring`` lays the ring out on the mesh, every collective
returns at once, and the state and batch are ``FakeTensorMode`` tensors
on the CPU device, which carry shapes and dtypes and no storage. The TAC
train step runs ONCE on them through the plain versions (the kernels'
wrappers send CPU tensors there, at the kernels' shapes) under the
analysis layer (``launch/hlo_analysis.profile``: the recorder,
``FlopCounterMode`` and ``MemTracker``), allocating and computing
nothing. Every peer issues the same schedule, so peer 0's log is the
per-peer program the reference's SPMD module is.

The artifact keeps the reference's keys: ``collectives`` (the issued
collectives' counts and result bytes), ``cost_analysis`` (counted FLOPs
and pre-fusion ``bytes_accessed``), ``memory_analysis``, the analytic
HBM bytes, the two roofline dicts, the model FLOPs and the param counts.
``compile_seconds`` holds the traced step's seconds. ``scan_corrected``
holds the counted costs themselves: the reference extrapolates from
unrolled 1- and 2-group variants because XLA's cost analysis counts a
scanned layer loop once (``repro/models/unroll.py``), while the port's
eager layer loop issues every layer's ops, so it needs no counterpart
of ``unroll.py``. The port adds ``cross_pod`` (the collectives by
in-pod and cross-pod, ``cross_pod_collective_count`` at the mesh's
in-pod size), ``global_batch`` and ``comm``. The TAC step gives each
peer an equal share of the global batch, so ``train_4k``'s 256
sequences do not split over multipod's 512 peers, in the reference
either (its lowering refuses the batch sharding): ``--global-batch``
replaces the shape's, and the artifact records it. ``--aggregate
channel`` under ``--mesh multipod`` runs the leader emission, whose
cross-pod collectives ``--flat-collectives`` compares.

Cells it cannot run raise a named ``NotImplementedError``: a ``gspmd``
cell (the GSPMD step family is not ported) and every prefill and decode
cell (the reference lowers those through the GSPMD serve steps).
``main`` records them as ``"status": "fail"`` with the error, as the
reference records any failure; ``"skip"`` keeps the reference's meaning
(``cell_skip_reason``). The dry run is an analysis tool: nothing in the
serve or train paths computes through it.

Usage (one process; the fake group cannot share it with a real one)::

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --mode hadronio                                  # 256 fake peers
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --mode hadronio --mesh multipod --global-batch 512 \\
      --aggregate channel                              # 2 pods = 512
  python -m repro_torch.launch.dryrun --all --mode hadronio
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import CommConfig, RunConfig
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, cell_skip_reason,
                                          get_config, get_shape)
from repro_torch.core.backends import available_modes, get_backend
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import steps
from repro_torch.launch.mesh import axis_size, make_production_mesh, make_ring
from repro_torch.models import api
from repro_torch.models.common import tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "torch")


def check_cell(shape, mode: str) -> None:
    """Raise the named error of a cell the port cannot trace yet."""
    if not get_backend(mode).manual:
        raise NotImplementedError(
            f"the dry run of mode {mode!r} needs the GSPMD step family "
            "(launch/sharding.py, FSDP2/DTensor), which is not ported to "
            "repro_torch yet (ROADMAP.md Queue 1 item 8); use a TAC mode "
            "such as hadronio")
    if shape.kind != "train":
        raise NotImplementedError(
            f"a {shape.kind} cell ({shape.name}) lowers through the GSPMD "
            "serve steps (make_prefill_step / make_decode_step), which are "
            "not ported to repro_torch yet (ROADMAP.md Queue 1 item 8)")


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``"fake"`` process group of ``size``
    ranks, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a "
                           "process group is already initialized here")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_state(run: RunConfig, n_shards: int, pod_size: int):
    """The TAC state of one peer as fake tensors on the CPU device (call
    inside a ``FakeTensorMode``)."""
    like = steps.abstract_state(run, n_shards, pod_size)
    fake = lambda m: torch.empty(m.shape, dtype=m.dtype, device="cpu")
    ef = like.ef
    if ef is not None:
        ef = tuple(map(fake, ef)) if isinstance(ef, tuple) else fake(ef)
    return steps.TrainState(
        params=tree_map(fake, like.params),
        opt=like.opt._replace(mu=tree_map(fake, like.opt.mu),
                              nu=tree_map(fake, like.opt.nu)),
        step=0, ef=ef)


def trace_cell(run: RunConfig, mesh) -> hlo.Profile:
    """One TAC step of ``run`` on a fake ring over ``mesh``, profiled."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n = mesh.size
    with fake_world(n):
        ring = make_ring(mesh, channels=run.comm.channels)
        local = dataclasses.replace(
            run.shape, global_batch=run.shape.global_batch // n)
        if local.global_batch * n != run.shape.global_batch:
            raise ValueError(f"a global batch of {run.shape.global_batch} "
                             f"does not split over {n} peers")
        with FakeTensorMode():
            state = _fake_state(run, n, ring.pods)
            batch = api.input_specs(run.model, local, device="cpu")
            step_fn = steps.make_train_step(run, ring, donate=True)
            return hlo.profile(step_fn, state, batch)


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                mode: str = "gspmd", microbatches: int = 1,
                global_batch: int | None = None, extra: dict | None = None,
                **comm) -> dict:
    """Trace one cell's step; return the artifact dict. ``comm``: more
    ``CommConfig`` fields (``hierarchical``, ``aggregate``, ...) over
    the reference's defaults; ``global_batch`` replaces the shape's (the
    artifact records it)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    mesh_name = "multipod" if multi_pod else "pod"
    skip = cell_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "mode": mode, "status": "skip", "reason": skip}
    check_cell(shape, mode)
    mesh = make_production_mesh(multi_pod=multi_pod)
    run = RunConfig(model=cfg, shape=shape, microbatches=microbatches,
                    comm=CommConfig(mode=mode, **comm))
    t0 = time.perf_counter()
    prof = trace_cell(run, mesh)
    seconds = time.perf_counter() - t0

    n_chips = mesh.size
    coll = hlo.collective_stats(prof.log)
    cost = hlo.costs(prof)
    counted = {"flops": cost["flops"], "bytes": cost["bytes_accessed"],
               "coll_bytes": float(coll.total_bytes),
               "coll_ops": float(coll.total_ops),
               "variant_units": cfg.num_layers / (
                   len(cfg.block_pattern) if cfg.block_pattern else 1)}
    mf = hlo.model_flops(cfg, shape)
    ab = hlo.analytic_hbm_bytes(cfg, shape, n_chips,
                                tp=axis_size(mesh, "model"),
                                dp=axis_size(mesh, "data"))
    # compute from the analytic model FLOPs, memory from the analytic
    # traffic model, collectives from the issued schedule (per peer)
    terms = hlo.roofline_terms(flops=mf, hbm_bytes=ab,
                               collective_bytes=coll.total_bytes,
                               n_chips=n_chips, flops_are_global=True,
                               hbm_is_global=False)
    raw_terms = hlo.roofline_terms(
        flops=cost["flops"], hbm_bytes=cost["bytes_accessed"],
        collective_bytes=coll.total_bytes, n_chips=n_chips,
        flops_are_global=False)
    art = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": mode, "status": "ok",
        "n_chips": n_chips, "global_batch": shape.global_batch,
        "comm": dataclasses.asdict(run.comm),
        "compile_seconds": round(seconds, 2),
        "collectives": coll.as_dict(),
        "cost_analysis": cost,
        "scan_corrected": counted,
        "memory_analysis": prof.memory,
        "analytic_hbm_bytes_per_chip": ab,
        "roofline": terms,
        "roofline_raw_hlo": raw_terms,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "hlo_flops_corrected_per_chip": counted["flops"],
        "useful_flops_ratio": (mf / n_chips) / counted["flops"]
        if counted["flops"] else None,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "cross_pod": hlo.cross_pod_collective_count(
            prof.log, n_chips // axis_size(mesh, "pod")),
    }
    if extra:
        art.update(extra)
    return art


def artifact_path(arch: str, shape: str, mesh: str, mode: str,
                  out_dir: str) -> str:
    safe = arch.replace("/", "_").replace(".", "_")
    return os.path.join(out_dir, f"dryrun_{safe}_{shape}_{mesh}_{mode}.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", choices=[a for base in ARCH_IDS
                                      for a in (base, base + "-reduced")])
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    p.add_argument("--mode", default="gspmd",
                   choices=list(available_modes()))
    p.add_argument("--all", action="store_true",
                   help="run every (arch x shape) cell for --mesh/--mode")
    p.add_argument("--flat-collectives", action="store_true",
                   help="CommConfig.hierarchical=False: the pod axis of "
                        "--mesh multipod folded into one flat ring")
    p.add_argument("--aggregate", default="slice",
                   choices=list(CommConfig.AGGREGATES),
                   help="wire-flush granularity ('channel' under --mesh "
                        "multipod runs the leader emission)")
    p.add_argument("--slice-bytes", type=int, default=4 * 1024 * 1024)
    p.add_argument("--global-batch", type=int, default=None,
                   help="replace the shape's global batch (a TAC cell "
                        "needs one sequence per peer at least: train_4k's "
                        "256 does not split over multipod's 512)")
    p.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        p.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in cells:
        path = artifact_path(arch, shape, args.mesh, args.mode, args.out)
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skip"):
                    print(f"[cached] {arch} x {shape}")
                    continue
        try:
            art = dryrun_cell(arch, shape, multi_pod=args.mesh == "multipod",
                              mode=args.mode, global_batch=args.global_batch,
                              hierarchical=not args.flat_collectives,
                              aggregate=args.aggregate,
                              slice_bytes=args.slice_bytes)
        except Exception as e:     # noqa: BLE001 — recorded, counted, rc 1
            art = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "mode": args.mode, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            failures += 1
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
        status = art["status"]
        if status == "ok":
            r, m = art["roofline"], art["memory_analysis"]
            print(f"[ok]   {arch} x {shape} ({args.mesh},{args.mode}): "
                  f"traced {art['compile_seconds']}s, "
                  f"bottleneck={r['bottleneck']}, "
                  f"coll={art['collectives']['total_bytes'] / 1e9:.2f}GB, "
                  f"mem_temp={m['temp_size_in_bytes'] / 1e9:.2f}GB, "
                  f"peak={m['peak_size_in_bytes'] / 1e9:.2f}GB, "
                  f"cross_pod={art['cross_pod']['cross_pod_total']}")
        elif status == "skip":
            print(f"[skip] {arch} x {shape}: {art['reason'][:60]}")
        else:
            print(f"[FAIL] {arch} x {shape}: {art['error']}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
