"""Training entry point of the port.

Counterpart of ``repro/launch/train.py`` in its single-run form: a
``Trainer`` owns the ring, the step function and the data source, and
``run_loop`` trains from a state to ``total_steps``, data addressed by
step index. Checkpoints, the watchdog and restarts come in a later
slice (ROADMAP.md Queue 1).

The Trainer joins an existing ``torch.distributed`` default group (one
process per peer of the ring). Without one it creates a group of one
peer in-process (NCCL on the card, gloo on the CPU, a ``HashStore`` so
that no port is opened) and destroys it in :meth:`Trainer.close`.

CLI::

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 5 \\
      --global-batch 4 --seq-len 1024 --mode hadronio --compress bf16 \\
      --pack pallas

  # CPU-sized smoke run
  python -m repro_torch.launch.train --arch qwen2-0.5b-reduced \\
      --device cpu --steps 2 --global-batch 2 --seq-len 32

  # bucketed ZeRO-1 on a ring of 2 peers on the CPU (gloo)
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen2-0.5b-reduced --device cpu --steps 3 --global-batch 4 \\
      --seq-len 32 --mode hadronio_overlap_rs --compress bf16
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.backends import available_modes, get_backend
from repro_torch.core.channels import Ring
from repro_torch.data import DataConfig, batch_at, make_source
from repro_torch.launch import steps as steps_mod


class Trainer:
    def __init__(self, run: RunConfig, *, device: DeviceLike = None,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.run = run
        self.device = resolve_device(device)
        self.log_every = log_every
        self.log_fn = log_fn
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            dist.init_process_group(
                "nccl" if self.device.type == "cuda" else "gloo",
                store=dist.HashStore(), rank=0, world_size=1)
        try:
            self.ring = Ring(channels=run.comm.channels)
            self.source = make_source(run)
            self.dc = DataConfig(seq_len=run.shape.seq_len,
                                 global_batch=run.shape.global_batch,
                                 host_index=self.ring.rank,
                                 num_hosts=self.ring.world_size)
            self.step_fn = steps_mod.make_train_step(run, self.ring)
        except Exception:
            self.close()
            raise

    def init_state(self, seed: Optional[int] = None) -> steps_mod.TrainState:
        gen = torch.Generator(device=self.device).manual_seed(
            self.run.seed if seed is None else seed)
        if get_backend(self.run.comm.mode).manual:
            return steps_mod.init_tac_state(gen, self.run, self.device,
                                            n_shards=self.ring.world_size)
        return steps_mod.init_train_state(gen, self.run, self.device)

    def batch(self, step: int) -> dict:
        """This peer's batch for ``step`` on the device."""
        return {k: torch.as_tensor(v).long().to(self.device)
                for k, v in batch_at(self.source, self.dc, step).items()}

    def run_loop(self, state: Optional[steps_mod.TrainState] = None) -> dict:
        """Train from ``state`` (default: a fresh one from the run's seed)
        to ``total_steps``. Returns the final state, the per-step losses
        and the per-step seconds (host clock, each step ending in the
        loss read that waits for the card)."""
        run = self.run
        state = self.init_state() if state is None else state
        losses, step_s = [], []
        # the host builds batch k+1 while the card runs step k
        batch = self.batch(state.step)
        for step in range(state.step, run.total_steps):
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            if step + 1 < run.total_steps:
                batch = self.batch(step + 1)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            if step % self.log_every == 0 or step == run.total_steps - 1:
                self.log_fn(f"[trainer] step {step} loss {loss:.4f} "
                            f"gnorm {float(metrics['grad_norm']):.3f} "
                            f"lr {metrics['lr']:.2e}")
        return {"final_loss": losses[-1] if losses else None,
                "losses": losses, "step_s": step_s, "state": state}

    def close(self) -> None:
        """Destroy the process group this Trainer created (a joined
        group is left to its owner)."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_group = False


def build_run(args) -> RunConfig:
    cfg = get_config(args.arch)
    shape = ShapeConfig(name="cli", kind="train", seq_len=args.seq_len,
                        global_batch=args.global_batch)
    comm = CommConfig(mode=args.mode, slice_bytes=args.slice_bytes,
                      compress=args.compress, pack=args.pack,
                      aggregate=args.aggregate, flush=args.flush)
    return RunConfig(model=cfg, shape=shape, comm=comm, lr=args.lr,
                     total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     seed=args.seed)


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
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) raises when no card is present")
    args = p.parse_args(argv)

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
        trainer = Trainer(build_run(args), device=args.device,
                          log_fn=print if rank0 else lambda line: None)
        try:
            out = trainer.run_loop()
        finally:
            trainer.close()
    finally:
        if own_group:
            dist.destroy_process_group()
    if rank0:
        print(f"final loss: {out['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
