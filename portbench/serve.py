"""The serving cells: the port's front door under a traffic mix.

The window drives what ``launch/serve.py`` builds: an ``EventLoopGroup``
from ``serving.engine.make_engine_group`` (one event loop, busy
polling) over a one-peer NCCL ring of the mix's channel communicators,
each loop's ``DecodeEngine.generate`` running
``serving/dispatch.make_serve_step`` in the mix's comm mode, then
``models/api.prefill`` and ``decode_step`` and the kernels. Requests
join at flush boundaries through the engine's admission seam
(``admission_hook``), as the chaos plane and the supervisor join them.

The engine returns no per-request times, so the harness times requests
at its public seams and copies no scheduling policy. Every prefill,
every admission and every flush boundary waits on the loop's
``Poller``; the harness gives the loop a ``Poller`` of the same kind
that notes the time when each wait returns, and reads the engine's
counters there: a wait after ``prefills`` grew is a prefill's (its
logits are ready: the first token of each of its requests exists), an
admission's when ``admit_prefills`` grew too; any other wait is a flush
boundary, after a decode step when ``decode_steps`` grew (each request
in a slot then has one more token). Which requests a prefill held
follows from the documented order: a wave takes the first ``max_batch``
requests given to ``generate``, and an admission takes, from the front
of the FIFO run queue, one request per row of its logits (one peer).
A request is done at the boundary that brings it to its output length
(greedy, no end token). The harness checks this account against the
tokens the engine returns.
"""
from __future__ import annotations

import gc
import sys
import time
from collections import deque

import numpy as np
import torch

from portbench import devtrace, program, weights
from portbench.spec import find_generator, find_reference


class Req:
    """One request of the traffic and what the harness saw of it: when
    it was due, when its first token existed, when it was done (host
    ``perf_counter`` seconds), its prompt's padded length in its
    prefill and the tokens the engine returned."""
    __slots__ = ("uid", "prompt", "max_new", "due_abs", "first", "done",
                 "produced", "padded_len", "tokens")

    def __init__(self, d: dict, t0: float):
        self.uid, self.prompt, self.max_new = d["uid"], d["prompt"], \
            d["max_new"]
        self.due_abs = t0 + d["due"]
        self.first = self.done = None
        self.produced = 0
        self.padded_len = 0
        self.tokens = None


class Tracker:
    """The account of one engine's requests, kept from its poller's
    waits (module docstring)."""

    def __init__(self, eng, max_batch: int, win: devtrace.Window):
        self.eng, self.max_batch, self.win = eng, max_batch, win
        self.queue: deque = deque()      # the engine's run queue, mirrored
        self.call: list = []             # the requests of this generate
        self.live: list = []
        self.admitted: dict = {}         # uid -> Req of every request given
        self.decode_tokens = 0
        self.hook = None                 # extra requests at a boundary
        self.sync()

    def sync(self) -> None:
        e = self.eng
        self.seen = (e.prefills, e.admit_prefills, e.decode_steps)

    def start_call(self, reqs: list) -> None:
        self.call = reqs
        self.queue = deque(reqs[self.max_batch:])

    def on_wait(self, tree) -> None:
        t = time.perf_counter()
        e = self.eng
        p, a, d = e.prefills, e.admit_prefills, e.decode_steps
        if p > self.seen[0]:
            if a > self.seen[1]:
                batch = [self.queue.popleft() for _ in range(tree.shape[0])]
            else:
                batch = self.call[:self.max_batch]
            padded = max(len(r.prompt) for r in batch)
            for r in batch:
                r.first, r.produced, r.padded_len = t, 1, padded
                self.live.append(r)
        else:
            if d > self.seen[2]:
                self.decode_tokens += len(self.live)
                for r in self.live:
                    r.produced += 1
            still = []
            for r in self.live:
                if r.produced >= r.max_new:
                    r.done = t
                else:
                    still.append(r)
            self.live = still
        self.seen = (p, a, d)
        self.win.tick(t)

    def admission_hook(self, _engine, _step):
        extra = self.hook(self) if self.hook is not None else []
        self.queue.extend(extra)
        return [as_request(r) for r in extra]


def as_request(r: Req):
    from repro_torch.serving.engine import Request
    return Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new)


def _timed_poller(base, tracker):
    from repro_torch.serving.event_loop import Poller

    class TimedPoller(Poller):
        """The loop's poller, noting when each wait returns."""

        def wait(self, tree):
            super().wait(tree)
            tracker.on_wait(tree)
            return tree
    return TimedPoller(base.poll, base.spin_s)


def _drive_open_loop(group, tracker: Tracker, reqs: list, clock, win):
    """Send each request when it is due: at a flush boundary through the
    admission hook while the engine is busy, else as a new call."""
    future = deque(sorted(reqs, key=lambda r: r.due_abs))

    def due_now(_tracker):
        now = clock()
        out = []
        while future and future[0].due_abs <= now:
            out.append(future.popleft())
        return out

    tracker.hook = due_now
    lateness = []
    while future:
        now = clock()
        win.tick(now)
        if future[0].due_abs > now:
            time.sleep(min(future[0].due_abs - now, 0.05))
            continue
        batch = due_now(tracker)
        lateness.append(clock() - batch[0].due_abs)
        _run_call(group, tracker, batch)
    return lateness


def _drive_backlog(group, tracker: Tracker, reqs: list, t_end: float,
                   clock):
    """Keep the run queue holding as many requests as there are free
    slots, from a backlog queued at the window's start, until the window
    closes; then let the requests in the slots finish."""
    backlog = deque(reqs)

    def top_up(tr):
        if clock() >= t_end:
            return []
        need = tr.max_batch - len(tr.live) - len(tr.queue)
        return [backlog.popleft() for _ in range(min(need, len(backlog)))]

    tracker.hook = top_up
    _run_call(group, tracker, [backlog.popleft()
                               for _ in range(tracker.max_batch)])


def _run_call(group, tracker: Tracker, batch: list) -> None:
    tracker.start_call(batch)
    group.submit([as_request(r) for r in batch])
    for res in group.run(threads=False):
        tracker.admitted[res.uid].tokens = np.asarray(res.tokens)


def setup(cell, seed: int, device, trace: bool):
    """The ring, the weights, the group and the warm-up."""
    import torch.distributed as dist
    from repro_torch.configs.base import CommConfig, ServeConfig
    from repro_torch.core.channels import Ring
    from repro_torch.serving import make_engine_group

    cfg, mix = cell.config, cell.traffic
    pcfg = program.model_config(cfg)
    program.check_layout(cfg, pcfg)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    c, e = mix["comm"], mix["engine"]
    ring = Ring(channels=c["channels"])
    marks = [time.perf_counter()]
    flat = weights.make(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    serve = ServeConfig(event_loops=e["event_loops"], poll=e["poll"],
                        max_batch=e["max_batch"], max_len=e["max_len"],
                        comm=CommConfig(mode=c["mode"],
                                        channels=c["channels"],
                                        aggregate=c["aggregate"],
                                        flush=c["flush"]))
    group = make_engine_group(pcfg, weights.nest(flat), serve, seed=seed,
                              device=device, ring=ring)
    if group.n_loops != 1:
        raise SystemExit("the serving harness drives one event loop")
    loop = group.loops[0]
    tracker = Tracker(loop.engine, e["max_batch"], devtrace.Window(False))
    loop.poller = loop.engine.poller = _timed_poller(loop.poller, tracker)
    loop.engine.admission_hook = tracker.admission_hook

    # warm-up: the longest prompts of the mix fill every slot, two more
    # are admitted at a boundary, and a few decode steps follow: every
    # kernel built, every channel communicator's first collective made
    rng = np.random.default_rng(0)
    p = mix["prompt"]
    mb = e["max_batch"]
    warm = [{"uid": -1 - i, "due": 0.0,
             "prompt": rng.integers(0, cfg["vocab_size"],
                                    p["max"] if i < mb else p["min"],
                                    dtype=np.int32),
             "max_new": 3 if i < mb else 2} for i in range(mb + 2)]
    wreqs = [Req(w, time.perf_counter()) for w in warm]
    extra = deque(wreqs[mb:])
    tracker.hook = lambda tr: [extra.popleft()] if extra else []
    tracker.admitted = {r.uid: r for r in wreqs}
    _run_call(group, tracker, wreqs[:mb])
    if trace and device.type == "cuda":
        devtrace.warm_profiler()
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    print(f"[setup] weights {marks[1] - marks[0]:.2f} s, group and warm-up "
          f"{marks[2] - marks[1]:.2f} s", file=sys.stderr)
    return {"flat": flat, "ring": ring, "group": group, "tracker": tracker,
            "own_group": own_group}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    """Set up, measure for ``seconds``, check. Returns the pieces of the
    result line (``harness.result_line`` makes it)."""
    import torch.distributed as dist
    st = setup(cell, seed, device, trace)
    try:
        return _run(cell, seed, seconds, trace, device, t_process, st)
    finally:
        st["ring"].close()
        if st["own_group"] and dist.is_initialized():
            dist.destroy_process_group()


def window(st: dict, cell, seed: int, seconds: float, trace: bool, device,
           mix: dict = None) -> dict:
    """One measured window of ``mix`` (default: the cell's) on a set-up
    group; returns the run's record, its peak memory with it. A mix with
    a ``backlog`` keeps the slots full from it; any other sends each
    request when it is due."""
    from repro_torch.obs import trace as obs_trace
    cfg, mix = cell.config, mix or cell.traffic
    tracker, group = st["tracker"], st["group"]
    gen = find_generator(mix["generator"], cell.bench)
    clock = time.perf_counter
    drawn = gen.generate(mix, seed, seconds, cfg["vocab_size"])
    tracker.live, tracker.decode_tokens = [], 0
    tracker.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    reqs = [Req(d, t0) for d in drawn]
    tracker.admitted = {r.uid: r for r in reqs}
    t_end = t0 + seconds
    prof = mix["profile"]
    a = t0 + prof["start_frac"] * seconds
    win = devtrace.Window(trace and device.type == "cuda", a,
                          a + prof["seconds"])
    tracker.win = win
    epoch = None
    if trace:
        epoch = clock()
        obs_trace.enable(1 << 20)
    counters0 = tracker.seen
    if "backlog" in mix:
        _drive_backlog(group, tracker, reqs, t_end, clock)
    else:
        lateness = _drive_open_loop(group, tracker, reqs, clock, win)
        print(f"[load] open loop: {len(lateness)} calls started idle, "
              f"generator late by median {np.median(lateness) * 1e3:.3f} "
              f"ms, max {max(lateness) * 1e3:.3f} ms", file=sys.stderr)
    if win.t_start is not None and win.t_stop is None:
        win.end()
    t_drained = clock()
    rec = obs_trace.disable() if trace else None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    counters = tuple(b - a for a, b in zip(counters0, tracker.seen))
    spans = [] if rec is None else [(s.kind, epoch + s.t0, epoch + s.t1)
                                    for s in rec.spans]
    return {"cfg": cfg, "mix": mix, "t0": t0, "t_end": t_end,
            "t_drained": t_drained, "requests": reqs,
            "handed": [r for r in reqs if r.first is not None],
            "counters": counters, "decode_tokens": tracker.decode_tokens,
            "spans": spans, "win": win, "peak": peak}


def _run(cell, seed, seconds, trace, device, t_process, st) -> dict:
    t = time.perf_counter()
    finger = weights.fingerprint(st["flat"])
    print(f"[setup] the weights' fingerprint {time.perf_counter() - t:.2f} s",
          file=sys.stderr)
    rec = window(st, cell, seed, seconds, trace, device)
    backlog = "backlog" in rec["mix"]
    # the program's state goes before the reference runs
    del st["group"]
    st["tracker"].eng = None
    gc.collect()
    reqs, handed = rec["requests"], rec["handed"]
    checks = check(cell, seed, st["flat"], finger, reqs, handed, device)
    judged = handed if backlog else reqs
    return {"record": rec, "setup_s": rec["t0"] - t_process,
            "peak": rec["peak"], "checks": checks, "attempted": len(judged),
            "failed": sum(1 for r in judged if r.done is None)}


def consistent(reqs: list) -> list:
    """Requests whose returned tokens disagree with the harness's
    account of them (their count against the output length)."""
    return [r.uid for r in reqs if r.done is not None and (
        r.tokens is None or len(r.tokens) != r.max_new)]


def sample(reqs: list, seed: int, tokens: int) -> list:
    """Finished requests for the reference: the one with the most output
    tokens (the longest prompt among those), then others in an order the
    seed draws, until ``tokens`` served tokens are in."""
    done = [r for r in reqs if r.done is not None and r.tokens is not None]
    if not done:
        return []
    first = max(done, key=lambda r: (r.max_new, len(r.prompt), -r.uid))
    rest = [r for r in done if r is not first]
    order = np.random.default_rng([int(seed) % (1 << 63), 7]).permutation(
        len(rest))
    out, n = [first], first.max_new
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += rest[i].max_new
    return out


def logit_gaps(logits: list, seqs: list, pick=None) -> list:
    """For each request, for each of its served tokens, how far the
    token's logit lies below the reference's best at that position (one
    array a request). ``pick`` (one (n, V) tensor per sequence) chooses
    the token instead of the served one: the control's first choice."""
    out = []
    for i, (lg, s) in enumerate(zip(logits, seqs)):
        if pick is None:
            tok = torch.as_tensor(np.asarray(s["served"]), device=lg.device)
        else:
            tok = pick[i].argmax(-1)
        best = lg.max(-1).values
        out.append((best - lg.gather(1, tok.long()[:, None])[:, 0])
                   .cpu().double().numpy())
    return out


# the statistics of the served tokens' logit gaps (one array a request)
# that a cell may compare: over every served token of the sample the
# widest and the median, and the worst request's median (a request served
# wrong throughout, as from one faulty slot, reads high there however few
# its tokens); a cell compares those its limits file names
GAP_STATS = {
    "logit_gap": lambda g: float(np.concatenate(g).max()),
    "logit_gap_median": lambda g: float(np.median(np.concatenate(g))),
    "request_median_gap": lambda g: float(max(np.median(x) for x in g)),
}


def sampled(reqs: list, seed: int, tokens: int) -> list:
    """The sample's sequences (``sample``) as the reference reads them."""
    return [{"prompt": r.prompt, "served": r.tokens,
             "padded_len": r.padded_len} for r in sample(reqs, seed, tokens)]


def reference_gaps(cell, flat: dict, seqs: list) -> list:
    """The plain float32 reference's logit gaps of the served tokens of
    ``seqs`` (``logit_gaps``)."""
    if not seqs:
        return [np.array([np.inf])]
    ref = find_reference(cell.config, cell.bench)
    ref.strict_f32()
    t = time.perf_counter()
    gaps = logit_gaps(ref.served_logits(flat, cell.config, seqs), seqs)
    every = np.concatenate(gaps)
    print(f"[check] reference over {len(seqs)} requests, {every.size} "
          f"served tokens in {time.perf_counter() - t:.2f} s; gap quantiles "
          f"50/75/90/99/100%: {np.quantile(every, [.5, .75, .9, .99, 1.])}; "
          f"{', '.join(f'{n} {fn(gaps)!r}' for n, fn in GAP_STATS.items())}",
          file=sys.stderr)
    return gaps


def check(cell, seed: int, flat: dict, finger: dict, reqs: list,
          handed: list, device) -> dict:
    """The numbers that decide ``correct``, each beside its limit."""
    lim = cell.limits
    unfinished = sum(1 for r in handed if r.done is None)
    bad = consistent(reqs)
    changed = sum(1 for k, v in weights.fingerprint(flat).items()
                  if v != finger[k])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = reference_gaps(cell, flat, sampled(
        reqs, seed, cell.traffic["check"]["tokens"]))
    checks = {name: {"value": fn(gaps), "limit": lim[name]}
              for name, fn in GAP_STATS.items() if name in lim}
    checks.update({
        "tokens_short": {"value": max(0, cell.traffic["check"]["tokens"]
                                      - sum(g.size for g in gaps)),
                         "limit": 0},
        "unfinished": {"value": unfinished, "limit": 0},
        "miscounted": {"value": len(bad), "limit": 0},
        "weights_changed": {"value": changed, "limit": 0},
    })
    return checks
