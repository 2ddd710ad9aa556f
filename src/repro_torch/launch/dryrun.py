"""The dry run: one cell's train or serve step traced on a fake process
group.

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

A ``gspmd`` train cell, and every prefill and decode cell whatever the
mode (the reference lowers those through the GSPMD serve steps), runs
the GSPMD step family instead (``trace_gspmd_cell``): a
``launch/mesh.make_device_mesh`` over the fake group, ``(16, 16)`` or
``(2, 16, 16)`` with a pod axis, and the step once on DTensors over
fake local blocks: ``make_train_step_gspmd`` from a state at
``train_state_shardings`` on the global batch, or ``make_prefill_step``
/ ``make_decode_step`` on ``serve_specs``' layouts. DTensor's
propagation owns its collectives (``_c10d_functional``, which the
recorder reads), so their counts are DTensor's schedule, not XLA's:
they are not the reference's (``PERF.md`` sets them side by side). The
flash kernel launches outside the dispatcher and is not in the log
(``hlo_analysis``); on the fake CPU blocks a prefill cell's attention is
its plain version in ``kernels/ref``, whose ops and full (S, S) scores
the log, the FLOPs and the memory estimate count.

The recurrent families (rwkv6, recurrentgemma) trace their gspmd,
prefill and decode cells too, ``long_500k`` included: their scans run
on each peer's fake local blocks. A fake op costs about a millisecond
of host time whatever its size, so the plain step loops of
``kernels/ref`` (one small op per step: a 32k-token prefill of the
reduced rwkv6 traced in 27 minutes) give way, for the whole trace, to
their log-depth forms (``ref.wkv6_log_depth``, ``ref.rglru_log_depth``:
the same recurrence as a prefix scan in O(log T) ops,
:func:`_log_depth_scans`). The log then counts those ops, and the
memory estimate their per-step states (B, T, H, hs, hs), where the
card's kernel keeps one state.

Every family traces its gspmd, prefill and decode cells (every
family's ``shard_fn`` sites are threaded: ``steps.GSPMD_FAMILIES``);
``long_500k`` is a ``"skip"`` with the reference's reason for the
full-attention families (``cell_skip_reason``). ``main`` records a cell
that raises as ``"status": "fail"`` with the error, as the reference
records any failure. The dry run is an analysis tool: nothing in the
serve or train paths computes through it.

Usage (one process; the fake group cannot share it with a real one)::

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --mode hadronio                                  # 256 fake peers
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
      --mode hadronio --mesh multipod --global-batch 512 \\
      --aggregate channel                              # 2 pods = 512
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
      --shape decode_32k                       # gspmd serve step, (16, 16)
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
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import CommConfig, RunConfig
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, cell_skip_reason,
                                          get_config, get_shape)
from repro_torch.core.backends import available_modes, get_backend
from repro_torch.kernels import ref
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import steps
from repro_torch.launch.mesh import (axis_size, make_device_mesh,
                                     make_production_mesh, make_ring)
from repro_torch.launch.sharding import distribute_tree
from repro_torch.models import api
from repro_torch.models.common import tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "torch")


@contextlib.contextmanager
def _log_depth_scans():
    """``kernels.ref.wkv6`` and ``ref.rglru`` as their log-depth forms
    for the duration (module docstring): the kernels' wrappers hand CPU
    tensors to those module attributes, and train mode calls them."""
    saved = ref.wkv6, ref.rglru
    ref.wkv6, ref.rglru = ref.wkv6_log_depth, ref.rglru_log_depth
    try:
        yield
    finally:
        ref.wkv6, ref.rglru = saved


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


def _fake(like):
    """A tree of ``meta`` tensors as fake tensors on the CPU device (call
    inside a ``FakeTensorMode``)."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device="cpu"), like)


@contextlib.contextmanager
def _real_strided_offsets():
    """DTensor's redistribution planner computes a ``_StridedShard``'s
    local size from a ``torch.arange`` of the dim's indices, read back
    with ``tolist()`` (torch 2.13): under an active ``FakeTensorMode``
    that ``arange`` is fake and the read raises
    ``DataDependentOutputException``. A strided shard arises wherever
    DTensor flattens two sharded dims into one (a reduced rwkv6's train
    step does, in a batched product). Inside this
    context that index arithmetic runs on real tensors (the fake mode
    unset for its duration): sizes of the mesh's blocks, not data.
    Skipped where the attribute is absent."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def trace_gspmd_cell(run: RunConfig, mesh) -> hlo.Profile:
    """One GSPMD step of ``run`` over a ``DeviceMesh`` of ``mesh``'s
    shape on the fake group, profiled: a ``gspmd`` train step
    (``make_train_step_gspmd``) from a state at ``train_state_shardings``
    on the global batch, or a serve step (``make_prefill_step`` /
    ``make_decode_step``) on ``serve_specs``' layouts, every leaf a
    DTensor over fake local blocks."""
    shape = run.shape
    with fake_world(mesh.size):
        dmesh = make_device_mesh(mesh.dims, mesh.axis_names, "cpu")
        with FakeTensorMode(), _real_strided_offsets():
            if shape.kind == "train":
                like = steps.abstract_train_state(run)
                full = steps.TrainState(
                    _fake(like.params), like.opt._replace(
                        mu=_fake(like.opt.mu), nu=_fake(like.opt.nu)), 0)
                state = steps.distribute_state(
                    full, steps.train_state_shardings(dmesh, run))
                batch = api.input_specs(run.model, shape, device="cpu")
                step_fn = steps.make_train_step_gspmd(run, dmesh,
                                                      donate=True)
                return hlo.profile(step_fn, state, batch)
            params, cache, inputs, psh, csh, ish = steps.serve_specs(
                run, shape, dmesh)
            params = distribute_tree(_fake(params), psh)
            inputs = distribute_tree(_fake(inputs), ish)
            if shape.kind == "prefill":
                return hlo.profile(steps.make_prefill_step(run, dmesh),
                                   params, inputs)
            cache = distribute_tree(_fake(cache), csh)
            return hlo.profile(steps.make_decode_step(run, dmesh), params,
                               cache, inputs)


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
    mesh = make_production_mesh(multi_pod=multi_pod)
    run = RunConfig(model=cfg, shape=shape, microbatches=microbatches,
                    comm=CommConfig(mode=mode, **comm))
    t0 = time.perf_counter()
    tac = shape.kind == "train" and get_backend(mode).manual
    with _log_depth_scans():
        prof = (trace_cell if tac else trace_gspmd_cell)(run, mesh)
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
