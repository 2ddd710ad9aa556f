"""Fault-tolerant training entry point of the port.

Counterpart of ``repro/launch/train.py``:

* ``Trainer`` owns the ring, the step function, the checkpoint store and
  the data source. ``run_loop()`` trains from the latest checkpoint (or
  a fresh state) to ``total_steps``; data is addressed by step index,
  so a resume needs nothing beyond the restored step counter. It saves
  every ``checkpoint_every`` steps and at the end.
* ``train_with_restarts`` — the supervision loop: a step that raises
  (an injected fault, a lost peer) closes its Trainer, and a new one
  restores from the last checkpoint and continues, up to
  ``max_restarts`` times.
* ``Watchdog`` — a timer that ends the process out of a step stuck
  longer than ``watchdog_secs`` (a dead peer shows as a hang in a
  synchronous step; the cluster manager restarts the process, which
  resumes from ``LATEST``).
* Elastic restarts onto a ring of another size: ``launch/elastic.py``.

Fault injection for tests and demos: ``REPRO_FAULT_AT_STEP=<k>`` makes
step k raise once; the flag file ``REPRO_FAULT_FLAG`` (default
``/tmp/repro_fault_fired``) keeps it to once per process tree.

The Trainer joins an existing ``torch.distributed`` default group (one
process per peer of the ring). Without one it creates a group of one
peer in-process (NCCL on the card, gloo on the CPU, a ``HashStore`` so
that no port is opened) and destroys it in :meth:`Trainer.close`.

A TAC mode runs on the ring (``--mesh`` folds every axis into it,
pod-major). ``gspmd`` with ``--mesh`` (or on more than one peer, where
the default is the reference's one ``data`` axis of every peer) runs on
a ``DeviceMesh`` of that shape (``launch/mesh.make_device_mesh``): the
state is DTensors at ``steps.train_state_shardings``, each step takes
the global batch, and checkpoints are written in the global layout and
restored onto whatever mesh the new Trainer has. ``gspmd`` on one peer
without ``--mesh`` trains plain tensors, as before.

``--trace-out PATH`` records the run's spans (``obs/trace.py``: the
step's ``step`` / ``forward`` / ``backward`` / ``update`` and the
exchange's) and writes them as Chrome-trace JSON, with the clock anchor
that lays them over a ``torch.profiler`` trace (rank 0's).

CLI::

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50 \\
      --global-batch 4 --seq-len 1024 --mode hadronio --compress bf16 \\
      --pack pallas --microbatches 2 --ckpt /path/run1 --ckpt-every 10 \\
      --data /path/shards

  # CPU-sized smoke run
  python -m repro_torch.launch.train --arch qwen2-0.5b-reduced \\
      --device cpu --steps 2 --global-batch 2 --seq-len 32

  # gspmd over a (data, model) mesh of 2 x 2 gloo peers: FSDP over
  # data, TP and SP over model, DTensor owning every collective
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen1.5-4b-reduced --device cpu --steps 3 --global-batch 8 \\
      --seq-len 32 --mode gspmd --mesh 2x2

  # two pods of two peers (the reference's --mesh 2x2x1): collectives
  # two-level, the ZeRO-1 shards in-pod and replicated across pods
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-0.5b-reduced --device cpu --steps 3 --global-batch 4 \\
      --seq-len 32 --mode hadronio_rs --mesh 2x2x1

  # ZeRO-1 on a ring of 2 peers on the CPU (gloo), then continued on 4:
  # the restore re-slices the flat moment shards
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-0.5b-reduced --device cpu --steps 4 --global-batch 4 \\
      --seq-len 32 --mode hadronio_rs --compress bf16 --ckpt /path/run2 \\
      --ckpt-every 2
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-0.5b-reduced --device cpu --steps 8 --global-batch 4 \\
      --seq-len 32 --mode hadronio_rs --compress bf16 --ckpt /path/run2 \\
      --ckpt-every 2
"""
from __future__ import annotations

import argparse
import gc
import os
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointStore
from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.backends import available_modes, get_backend
from repro_torch.core.channels import Ring
from repro_torch.data import DataConfig, batch_at, make_source
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.elastic import make_on_mismatch
from repro_torch.launch.mesh import (Mesh, make_device_mesh, make_ring,
                                     parse_mesh)
from repro_torch.obs import trace as obs_trace


class WatchdogTimeout(RuntimeError):
    """The reference's name for a watchdog's expiry. Neither package
    raises it: the watchdog ends the process (exit code 42) instead,
    since a step stuck in a collective cannot be interrupted by an
    exception."""


class Watchdog:
    """Calls ``on_timeout`` when armed longer than ``timeout_secs``:
    ``arm()`` before blocking work, ``disarm()`` after (one timer
    thread)."""

    def __init__(self, timeout_secs: float, on_timeout: Callable[[], None]):
        self.timeout = timeout_secs
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None

    def arm(self):
        self.disarm()
        self._timer = threading.Timer(self.timeout, self.on_timeout)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def _maybe_inject_fault(step: int):
    at = os.environ.get("REPRO_FAULT_AT_STEP")
    if at is None:
        return
    flag = os.environ.get("REPRO_FAULT_FLAG", "/tmp/repro_fault_fired")
    if int(at) == step and not os.path.exists(flag):
        with open(flag, "w") as f:
            f.write(str(step))
        raise RuntimeError(f"injected fault at step {step}")


class Trainer:
    """``donate``: each step consumes the state it is given
    (``steps.make_train_step``), so the state passed to :meth:`run_loop`
    must not be read again; the reference's Trainer always donates, and
    so does the CLI. ``mesh`` (``launch/mesh.Mesh``; None: one flat ring
    of every peer) lays the peers out as the reference's train mesh: for
    a TAC mode its axes flattened pod-major into one ring, with the pod
    axis as the ring's (``mesh.make_ring``); for ``gspmd`` a
    ``DeviceMesh`` of its shape (``self.mesh``; None on one peer without
    a mesh)."""

    def __init__(self, run: RunConfig, mesh: Optional[Mesh] = None, *,
                 device: DeviceLike = None,
                 log_every: int = 10, watchdog_secs: float = 0.0,
                 log_fn: Callable[[str], None] = print,
                 donate: bool = False):
        self.run = run
        self.device = resolve_device(device)
        self.log_every = log_every
        self.log_fn = log_fn
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            dist.init_process_group(
                "nccl" if self.device.type == "cuda" else "gloo",
                store=dist.HashStore(), rank=0, world_size=1)
        self.store = None
        self.watchdog = None
        self.ring = self.mesh = None
        try:
            world = dist.get_world_size()
            if not get_backend(run.comm.mode).manual and (
                    mesh is not None or world > 1):
                m = mesh or Mesh((world,), ("data",))
                dmesh = make_device_mesh(m.dims, m.axis_names, self.device)
                if steps_mod.uses_dtensor(run, dmesh):
                    self.mesh = dmesh
            if self.mesh is None:
                self.ring = (Ring(channels=run.comm.channels)
                             if mesh is None else
                             make_ring(mesh, channels=run.comm.channels))
            self.source = make_source(run)
            # a DTensor step takes the global batch; a ring peer its share
            self.dc = DataConfig(
                seq_len=run.shape.seq_len,
                global_batch=run.shape.global_batch,
                host_index=0 if self.ring is None else self.ring.rank,
                num_hosts=1 if self.ring is None else self.ring.world_size)
            self.step_fn = steps_mod.make_train_step(
                run, self.ring, mesh=self.mesh, donate=donate)
            if run.checkpoint_dir:
                group = None if self.ring is None else self.ring.group
                self.store = CheckpointStore(
                    run.checkpoint_dir, keep=run.keep_checkpoints,
                    group=group or dist.group.WORLD,
                    rows=steps_mod.ring_rows)
        except Exception:
            self.close()
            raise
        if watchdog_secs > 0:
            def _abort():
                # end the process out of the stuck step; whoever restarts
                # it resumes from LATEST
                self.log_fn(f"[watchdog] step exceeded {watchdog_secs}s")
                os._exit(42)
            self.watchdog = Watchdog(watchdog_secs, _abort)

    # -- state ----------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> steps_mod.TrainState:
        gen = torch.Generator(device=self.device).manual_seed(
            self.run.seed if seed is None else seed)
        if get_backend(self.run.comm.mode).manual:
            return steps_mod.init_tac_state(gen, self.run, self.device,
                                            n_shards=self.ring.world_size,
                                            pod_size=self.ring.pods)
        state = steps_mod.init_train_state(gen, self.run, self.device)
        if self.mesh is None:
            return state
        return steps_mod.distribute_state(
            state, steps_mod.train_state_shardings(self.mesh, self.run))

    def restore_or_init(self) -> steps_mod.TrainState:
        """The latest checkpoint's state when there is one (a changed
        ring size is resolved by ``elastic.make_on_mismatch``), else a
        fresh state from the run's seed."""
        if self.store is not None:
            latest = self.store.latest_step()
            if latest is not None:
                self.log_fn(f"[trainer] restoring step {latest}")
                if self.mesh is not None:
                    return self.store.restore(
                        latest, steps_mod.abstract_train_state(self.run),
                        device=self.device,
                        shardings=steps_mod.train_state_shardings(
                            self.mesh, self.run))
                return self.store.restore(
                    latest, steps_mod.abstract_state(
                        self.run, self.ring.world_size, self.ring.pods),
                    on_mismatch=make_on_mismatch(self.run),
                    device=self.device)
        return self.init_state()

    def batch(self, step: int) -> dict:
        """This peer's batch for ``step`` on the device (over a
        ``DeviceMesh``: the global batch, which the step places)."""
        return {k: torch.as_tensor(v).long().to(self.device)
                for k, v in batch_at(self.source, self.dc, step).items()}

    # -- loop ------------------------------------------------------------

    def run_loop(self, state: Optional[steps_mod.TrainState] = None) -> dict:
        """Train from ``state`` (default: :meth:`restore_or_init`) to
        ``total_steps``, saving every ``checkpoint_every`` steps and at
        the end. Returns the final state, the per-step losses and the
        per-step seconds (host clock, each step ending in the loss read
        that waits for the card; a save's snapshot is not in them)."""
        run = self.run
        state = self.restore_or_init() if state is None else state
        losses, step_s = [], []
        # the host builds batch k+1 while the card runs step k
        batch = self.batch(state.step)
        for step in range(state.step, run.total_steps):
            _maybe_inject_fault(step)
            t0 = time.perf_counter()
            if self.watchdog:
                self.watchdog.arm()
            state, metrics = self.step_fn(state, batch)
            if step + 1 < run.total_steps:
                batch = self.batch(step + 1)
            loss = float(metrics["loss"])     # also waits for the card
            if self.watchdog:
                self.watchdog.disarm()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            if step % self.log_every == 0 or step == run.total_steps - 1:
                self.log_fn(f"[trainer] step {step} loss {loss:.4f} "
                            f"gnorm {float(metrics['grad_norm']):.3f} "
                            f"lr {metrics['lr']:.2e}")
            if self.store is not None and (
                    (step + 1) % run.checkpoint_every == 0
                    or step == run.total_steps - 1):
                save = (self.store.save_async if run.async_checkpoint
                        else self.store.save)
                save(step + 1, state,
                     extra={"loss": loss, "arch": run.model.name})
        if self.store is not None:
            self.store.wait()
        return {"final_loss": losses[-1] if losses else None,
                "losses": losses, "step_s": step_s, "state": state}

    def close(self) -> None:
        """Finish a pending checkpoint write, destroy the ring's channel
        communicators and the process group this Trainer created (a
        joined group is left to its owner)."""
        try:
            if self.watchdog is not None:
                self.watchdog.disarm()
            if self.store is not None:
                self.store.wait()
        finally:
            ring = getattr(self, "ring", None)
            if ring is not None and dist.is_initialized():
                ring.close()
            if self._owns_group and dist.is_initialized():
                dist.destroy_process_group()
                self._owns_group = False


def train_with_restarts(make_trainer: Callable[[], Trainer],
                        max_restarts: Optional[int] = None,
                        log_fn: Callable[[str], None] = print) -> dict:
    """Supervision loop: run a Trainer from ``make_trainer``; when a step
    raises, close it (its pending write lands, its own process group
    goes) and run a new one, which restores from the last checkpoint,
    up to ``max_restarts`` times (default: the run's). The last Trainer
    is closed too. Returns its ``run_loop`` result and ``restarts``."""
    trainer = make_trainer()
    limit = (trainer.run.max_restarts if max_restarts is None
             else max_restarts)
    attempts = 0
    while True:
        try:
            out = trainer.run_loop()
        except Exception as e:         # noqa: BLE001 — supervision boundary
            attempts += 1
            trainer.close()
            if attempts > limit:
                raise
            log_fn(f"[supervisor] step failed ({type(e).__name__}: {e}); "
                   f"restart {attempts}/{limit}")
        else:
            trainer.close()
            return dict(out, restarts=attempts)
        # the failed run's blocks go back to the card: the new ring's
        # communicators allocate outside PyTorch's caching allocator
        device = trainer.device
        del trainer
        if device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
        trainer = make_trainer()       # a fresh ring; restores LATEST


def build_run(args) -> RunConfig:
    cfg = get_config(args.arch)
    shape = ShapeConfig(name="cli", kind="train", seq_len=args.seq_len,
                        global_batch=args.global_batch)
    comm = CommConfig(mode=args.mode, slice_bytes=args.slice_bytes,
                      hierarchical=not args.flat_collectives,
                      compress=args.compress, pack=args.pack,
                      aggregate=args.aggregate, flush=args.flush)
    return RunConfig(model=cfg, shape=shape, comm=comm, lr=args.lr,
                     total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches,
                     checkpoint_dir=args.ckpt,
                     checkpoint_every=args.ckpt_every,
                     data_path=args.data, seed=args.seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True,
                   help="arch id; append -reduced for the smoke variant")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--mode", default="hadronio",
                   choices=list(available_modes()),
                   help="gradient exchange; the ZeRO-1 modes (hadronio_rs, "
                        "hadronio_overlap_rs) reduce-scatter the gradients "
                        "and shard the optimizer moments over the ring")
    p.add_argument("--compress", default="none",
                   choices=list(CommConfig.COMPRESS_CODECS))
    p.add_argument("--pack", default="jnp",
                   choices=list(CommConfig.PACK_IMPLS),
                   help="pack/unpack stage: pallas = the hand-written "
                        "ring_pack kernel, jnp = the eager path")
    p.add_argument("--aggregate", default="slice",
                   choices=list(CommConfig.AGGREGATES),
                   help="wire-flush granularity: one collective per ring "
                        "slice, or one coalesced flush per channel")
    p.add_argument("--flush", default="step",
                   choices=list(CommConfig.FLUSHES),
                   help="channel schedule: 'step' flushes every channel "
                        "at one end-of-exchange loop, 'ready' each channel "
                        "when its last slice is staged")
    p.add_argument("--slice-bytes", type=int, default=4 * 1024 * 1024)
    p.add_argument("--flat-collectives", action="store_true",
                   help="CommConfig.hierarchical=False: the pod axis of "
                        "--mesh AxBxC is folded into one flat ring")
    p.add_argument("--microbatches", type=int, default=1,
                   help="gradient accumulation: each peer's batch in this "
                        "many sequential microbatches, one exchange a step")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt", default="",
                   help="checkpoint directory: resume from its LATEST, save "
                        "into it (empty: no checkpoints)")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--data", default="",
                   help="directory of binary token shards (*.bin, a .meta "
                        "sidecar names uint16/uint32; else synthetic)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--watchdog-secs", type=float, default=0.0,
                   help="end the process when a step takes longer (0: off)")
    p.add_argument("--max-restarts", type=int, default=None,
                   help="restarts from the last checkpoint after a failed "
                        "step (default: the run config's)")
    p.add_argument("--mesh", default="",
                   help="'AxB' (data, model) or 'AxBxC' (pod, data, "
                        "model): the peers' layout; a TAC mode flattens "
                        "every axis pod-major into the ring, gspmd trains "
                        "on a DeviceMesh of this shape; the product must "
                        "be the world size (default: one data axis of "
                        "every peer)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) raises when no card is present")
    p.add_argument("--trace-out", default="",
                   help="write a Chrome-trace/Perfetto JSON of the run's "
                        "spans here (step, forward, backward, update and "
                        "the exchange's; enables tracing, which leaves "
                        "losses and parameters bit-identical)")
    args = p.parse_args(argv)
    mesh = parse_mesh(args.mesh) if args.mesh else None

    # under torchrun each process is one peer: join the launcher's ring
    own_group = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if own_group:
        device = resolve_device(args.device)
        if device.type == "cuda":     # one card per peer of the host
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
    try:
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        log = print if rank0 else lambda line: None
        run = build_run(args)
        if args.trace_out:
            obs_trace.enable()
        try:
            out = train_with_restarts(
                lambda: Trainer(run, mesh, device=args.device,
                                watchdog_secs=args.watchdog_secs, log_fn=log,
                                donate=True),
                max_restarts=args.max_restarts, log_fn=log)
        finally:
            rec = obs_trace.disable() if args.trace_out else None
    finally:
        if own_group:
            dist.destroy_process_group()
    if rank0:
        print(f"final loss: {out['final_loss']:.4f}")
        if rec is not None:
            doc = rec.write(args.trace_out)
            print(f"[train] span trace -> {args.trace_out} "
                  f"({len(doc['traceEvents'])} spans, kinds={rec.kinds()})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
