"""The training cells: one peer's donated step of the port's Trainer.

Set-up builds one ``repro_torch.launch.train.Trainer`` (its one-peer
ring of channel communicators, its donated step
``launch/steps.make_train_step``: the loss over sequential microbatches,
``core/tac`` through the mix's comm backend, ``core/backends/pipeline``
with the hand-written pack and unpack kernels, ``core/channels``, then
``optim/adamw`` in place) around the benchmark's weights, and drives
that step through its first steps on the benchmark's batches. The
window takes the same step and state on: one step after another, each
ending in the read of its loss, as the Trainer's own loop does, until
the window's seconds are spent.

The parameters are kept in the mix's ``param_dtype`` (float32 master
weights; the compute is in the configuration's type): in bfloat16 an
AdamW step below half a unit in the last place is lost, and the norms'
scales, at 1.0, would never move at the mix's learning rate.

What ``correct`` compares, at two points of the same state's life:

* the start: each of the first steps' loss; every leaf's norm of the
  gradient as the optimizer took it (its first moment after one step,
  over ``1 - beta1``); every leaf's norm of the change of the
  parameters over the first steps (taken before the next step
  overwrites them). The plain reference (``reference/decoder.train``)
  makes the weights and batches again from the seed and takes the same
  steps in float32.
* the end: once the window has closed, the state it reached (parameters
  and AdamW's moments, copied on the card) takes one more step through
  the window's own call, on the next batch. The same numbers of that
  step (``last_*``: its gradient is the change of the first moment,
  ``(mu' - beta1 mu) / (1 - beta1)``) are compared with the reference's
  step from the copied state, and the optimizer's count with the steps
  taken (``count_off``). The window's own steps are not replayed: the
  reference would need longer than the window.

Each comparison gives the loss's gap and, for the gradient and the
change, the worst leaf's gap and the median leaf's; a cell compares the
numbers its limits file names (``PERF.md`` says why those).
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import devtrace, program, weights
from portbench.spec import find_generator, find_reference


def run_config(cell, seed: int):
    from repro_torch.configs.base import CommConfig, RunConfig, ShapeConfig
    mix = cell.traffic
    pcfg = program.model_config(cell.config, mix["param_dtype"])
    c, o = mix["comm"], mix["optimizer"]
    return RunConfig(
        model=pcfg,
        shape=ShapeConfig("bench", "train", mix["seq_len"],
                          mix["global_batch"]),
        comm=CommConfig(mode=c["mode"], channels=c["channels"],
                        compress=c["compress"], pack=c["pack"],
                        aggregate=c["aggregate"], flush=c["flush"]),
        lr=o["lr"], weight_decay=o["weight_decay"], beta1=o["beta1"],
        beta2=o["beta2"], eps=o["eps"], grad_clip=o["grad_clip"],
        warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
        microbatches=mix["microbatches"], seed=seed)


def _param_dtype(mix: dict) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[mix["param_dtype"]]


def _norms(tree_flat: dict, div: float = 1.0) -> dict:
    return {k: float(v.double().norm()) / div for k, v in tree_flat.items()}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import Trainer
    from repro_torch.obs import trace as obs_trace
    cfg, mix = cell.config, cell.traffic
    run_cfg = run_config(cell, seed)
    program.check_layout(cfg, run_cfg.model)
    gen = find_generator(mix["generator"], cell.bench)
    batch = lambda i: gen.batch(mix, seed, i, cfg["vocab_size"], device)
    trainer = Trainer(run_cfg, device=device, donate=True,
                      log_fn=lambda _line: None)
    try:
        return _run(cell, seed, seconds, trace, device, t_process, trainer,
                    run_cfg, batch, steps_mod, obs_trace)
    finally:
        trainer.close()


def _run(cell, seed, seconds, trace, device, t_process, trainer, run_cfg,
         batch, steps_mod, obs_trace) -> dict:
    cfg, mix = cell.config, cell.traffic
    t = time.perf_counter()
    print(f"[setup] process start to the Trainer (imports, the ring's "
          f"communicators): {t - t_process:.2f} s", file=sys.stderr)
    flat = weights.make(cfg, seed, device, _param_dtype(mix))
    p0 = {k: v.clone() for k, v in flat.items()}
    state = steps_mod.tac_state(weights.nest(flat), run_cfg,
                                n_shards=trainer.ring.world_size)
    del flat
    n_check = mix["check"]["steps"]
    losses, grad = [], None
    for i in range(1, n_check + 1):
        state, m = trainer.step_fn(state, batch(i))
        losses.append(float(m["loss"]))
        if i == 1:
            grad = _norms(weights.flatten(state.opt.mu), 1.0 - run_cfg.beta1)
    change = {k: float((v.double() - p0[k].double()).norm())
              for k, v in weights.flatten(state.params).items()}
    del p0
    gc.collect()
    print(f"[setup] weights and {n_check} checked steps: "
          f"{time.perf_counter() - t:.2f} s", file=sys.stderr)
    if trace and device.type == "cuda":
        devtrace.warm_profiler()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    prof = mix["profile"]
    win = devtrace.Window(trace and device.type == "cuda")
    epoch = None
    if trace:
        epoch = time.perf_counter()
        obs_trace.enable(1 << 20)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    step, done, nxt = n_check + 1, 0, batch(n_check + 1)
    prof_first = prof_steps = None
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if win.on and win.t_start is None \
                and now - t0 >= prof["start_frac"] * seconds:
            win.begin()
            prof_first = done
        state, m = trainer.step_fn(state, nxt)
        nxt = batch(step + 1)
        loss = float(m["loss"])          # waits for the card
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {step}: loss {loss}")
        step += 1
        done += 1
        if win.t_start is not None and win.t_stop is None \
                and done - prof_first >= prof["steps"]:
            win.end()
            prof_steps = done - prof_first
    if win.t_start is not None and win.t_stop is None:
        win.end()
        prof_steps = done - prof_first
    t_end = time.perf_counter()
    rec = obs_trace.disable() if trace else None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    spans = [] if rec is None else [(s.kind, epoch + s.t0, epoch + s.t1)
                                    for s in rec.spans]
    record = {"cfg": cfg, "mix": mix, "t0": t0, "t_end": t_end,
              "steps": done, "spans": spans, "win": win,
              "profiled_steps": prof_steps or 0}
    del m, nxt
    t = time.perf_counter()
    after = after_window(trainer, state, batch, step, run_cfg.beta1)
    after["expected_count"] = n_check + done
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[check] the step after the window (state copied first): "
          f"{time.perf_counter() - t:.2f} s", file=sys.stderr)
    checks = check(cell, seed, device, batch,
                   {"losses": losses, "grad": grad, "change": change}, after)
    return {"record": record, "setup_s": setup_s, "peak": peak,
            "checks": checks, "attempted": done, "failed": 0}


def _copy(tree) -> dict:
    return {k: v.detach().clone() for k, v in weights.flatten(tree).items()}


def after_window(trainer, state, batch, step: int, beta1: float) -> dict:
    """The window's state copied (``snap``: parameters, moments, the
    optimizer's count; the donated step overwrites the originals), then
    one more step through the window's call on batch ``step``: its loss,
    every leaf's gradient norm as the optimizer took it and norm of the
    change (``prog``)."""
    snap = {"params": _copy(state.params), "m": _copy(state.opt.mu),
            "v": _copy(state.opt.nu), "count": int(state.opt.count)}
    state, m = trainer.step_fn(state, batch(step))
    loss = float(m["loss"])
    mu, params = weights.flatten(state.opt.mu), weights.flatten(state.params)
    grad, change = {}, {}
    for k, p in params.items():
        change[k] = float((p.double() - snap["params"][k].double()).norm())
        grad[k] = float((mu[k].double() - beta1 * snap["m"][k].double())
                        .norm()) / (1.0 - beta1)
    return {"prog": {"losses": [loss], "grad": grad, "change": change},
            "snap": snap, "step": step, "count": int(state.opt.count)}


def counted(ref_grad: dict) -> list:
    """Leaves whose reference gradient is more than round-off: at least
    a thousandth of the median leaf's (a key's bias under the softmax
    has none, and Adam moves it by round-off alone)."""
    med = float(np.median(list(ref_grad.values())))
    return sorted(k for k, v in ref_grad.items() if v >= 1e-3 * med)


def leaf_gaps(got: dict, want: dict, keys: list) -> dict:
    """Each leaf's gap of norms over ``keys``, against the reference's
    norm of the leaf or of the median leaf, whichever is larger."""
    med = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}


def compare(prog: dict, refd: dict) -> dict:
    """A training cell's numbers from the program's readings and the
    reference's: the loss's gap, the largest over steps; the gradient's
    and the change's, the worst leaf's (``*_gap``) and the median
    leaf's (``*_gap_median``)."""
    keys = counted(refd["grad"])
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(
        prog["losses"], refd["losses"])),
        "left_out": sorted(set(refd["grad"]) - set(keys))}
    for name in ("grad", "change"):
        gaps = leaf_gaps(prog[name], refd[name], keys)
        worst = max(gaps, key=gaps.get)
        out.update({f"{name}_gap": gaps[worst], f"{name}_leaf": worst,
                    f"{name}_gap_median": float(np.median(list(
                        gaps.values())))})
    return out


def reference(cell, seed: int, device, batch, precision: str = "f32") -> dict:
    """The reference's first steps from the seed."""
    mix = cell.traffic
    ref = find_reference(cell.config, cell.bench)
    ref.strict_f32()
    W = {k: v.float() for k, v in weights.make(
        cell.config, seed, device, _param_dtype(mix)).items()}
    batches = [batch(i) for i in range(1, mix["check"]["steps"] + 1)]
    return ref.train(W, cell.config, batches, mix["optimizer"],
                     mix["microbatches"], precision)


def reference_after(cell, device, batch, after: dict,
                    precision: str = "f32") -> dict:
    """The reference's step from the window's copied state."""
    mix, snap = cell.traffic, after["snap"]
    ref = find_reference(cell.config, cell.bench)
    ref.strict_f32()
    dev = lambda d: {k: v.to(device, torch.float32, copy=True)
                     for k, v in d.items()}
    moments = {"m": dev(snap["m"]), "v": dev(snap["v"]),
               "count": snap["count"]}
    return ref.train(dev(snap["params"]), cell.config,
                     [batch(after["step"])], mix["optimizer"],
                     mix["microbatches"], precision, moments)


NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
           "change_gap_median")


def check(cell, seed, device, batch, start: dict, after: dict) -> dict:
    lim = cell.limits
    out = {}
    for label, prog, run_ref in (
            ("", start, lambda: reference(cell, seed, device, batch)),
            ("last_", after["prog"],
             lambda: reference_after(cell, device, batch, after))):
        t = time.perf_counter()
        refd = run_ref()
        cmp = compare(prog, refd)
        print(f"[check] reference{' after the window' if label else ''}: "
              f"{len(refd['losses'])} steps in {time.perf_counter() - t:.2f}"
              f" s; losses program {prog['losses']} reference "
              f"{refd['losses']}; worst leaves: gradient {cmp['grad_leaf']},"
              f" change {cmp['change_leaf']}; left out (no gradient beyond "
              f"round-off): {cmp['left_out']}", file=sys.stderr)
        del refd
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out.update({label + n: cmp[n] for n in NUMBERS})
    out["count_off"] = abs(after["count"] - after["expected_count"] - 1)
    return {name: {"value": v, "limit": lim[name]}
            for name, v in out.items() if name in lim}
