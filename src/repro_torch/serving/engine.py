"""Batched decode engine: KV-cache manager + request batcher + sampler.

Counterpart of ``repro/serving/engine.py``.

* Attention families (dense, moe, encdec, vlm): prompts are
  **right-padded** to the batch maximum and tracked with per-request
  ``pos`` vectors: pad slots are never attended (validity mask
  ``j <= pos``) and the first generated token overwrites the first pad
  slot, so mixed-length batches are exact per row — but for the first
  token of encdec and vlm rows, which ``models/api.prefill`` reads where
  the reference does (its docstring).
* Recurrent families (ssm, hybrid): the recurrence would absorb pad
  tokens, so requests are grouped into **equal-length buckets** of at
  most ``max_batch`` (exact, no pads, no ``last_pos``), one wave per
  bucket, with no mid-flight admission — as in the reference.
* **Continuous batching** (attention families): the engine runs
  ``max_batch`` decode SLOTS.
  When requests finish, the freed slots are refilled from the run queue
  at the flush boundary (the decode-step boundary) with ONE batched
  prefill over every freed slot (prompts padded to ``ADMIT_PAD``), whose
  cache rows are written into the resident cache in place.
* Sampling: greedy, or temperature from the engine's own
  ``torch.Generator`` (no global RNG); stop on ``eos_id`` or ``max_new``.
* Steps come from ``serving/dispatch.py`` when a ``ServeConfig`` is
  given (collectives through the registered CommBackend over ``ring``,
  honouring the owning loop's channel affinity), else straight from
  ``models/api``. Over a ring of peers every peer runs the same engine
  on the same requests; batch rows are padded to the ring size.
  Completion waits go through the loop's
  :class:`~repro_torch.serving.event_loop.Poller`.
* **The flush-boundary fault window** (attention families):
  ``admission_hook(engine, step)`` is called at every decode-step
  boundary, after the poll and before admission; the requests it
  returns join the run queue and contend for freed slots (the chaos
  harness's admission storm, ``serving/chaos.py``). The admission
  control seam ``admission_gate(engine, step, extra)`` (the supervisor's,
  ``serving/supervisor.py``) then sees that burst and returns the
  requests actually admitted, so backpressure composes with storms.
* Telemetry (``obs/trace.py``), when tracing is on: ``prefill`` spans
  around each wave's prefill and its poller wait, ``decode`` around each
  decode call (its issue: the span closes before the card finishes),
  ``boundary`` around each flush boundary up to admission (the poller's
  wait for the sampled tokens, their read-back, the slot bookkeeping,
  the admission hook and gate) and ``admission`` around each batched
  admission. A wave's loop opens one ``boundary`` per decode step, and
  one more at the boundary that ends it.
* :func:`make_engine_group` takes an explicit channel ``affinity`` (the
  elastic reshard's partition) and ``ServeConfig.tenants``: contiguous
  per-tenant loop ranges, ``cfg``/``params`` single or per tenant; with
  ``ServeConfig.pods`` it is topology-aware (a pod ring, leader lanes
  pinned to the leader loops).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core.channels import Ring
from repro_torch.models import api
from repro_torch.models.common import tree_paths
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import dispatch
from repro_torch.serving.event_loop import (EventLoop, EventLoopGroup,
                                            Poller, channel_affinity)

ADMIT_PAD = 16      # admitted prompts pad to this granularity (bounded
#                     set of prefill shapes, as in the reference)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32
    max_new: int = 32
    temperature: float = 0.0      # 0 -> greedy
    priority: int = 0             # admission-control rank: LOWER sheds
    #                               first under backpressure (supervisor)
    tenant: str = ""              # names a ServeConfig.tenants entry ("":
    #                               the first tenant; single-tenant groups
    #                               ignore it)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray            # generated tokens (<= max_new)
    prompt_len: int
    steps: int


@dataclasses.dataclass
class _Slot:
    """One in-flight request occupying a decode slot."""
    req: Request
    admitted_step: int
    toks: list
    done: bool = False


class DecodeEngine:
    """Synchronous batched engine around prefill/decode_step on
    ``device`` (the card unless "cpu"). ``params`` must already live
    there. ``ring`` is the ring of peers the serve step emits over
    (None = one peer, no process group). ``prefills`` counts prefill
    calls (one per wave + one per admission round), ``admit_prefills``
    the admission rounds alone and ``decode_steps`` the decode calls.
    ``admission_hook`` is the flush-boundary fault window and
    ``admission_gate`` the admission-control seam (module docstring);
    None is a no-op / admits everything."""

    def __init__(self, cfg: ModelConfig, params: Any, *,
                 max_batch: int = 8, max_len: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0,
                 serve: Optional[ServeConfig] = None,
                 channel_indices: Optional[tuple] = None,
                 poller: Optional[Poller] = None,
                 device: DeviceLike = None, ring: Optional[Ring] = None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.poller = poller or Poller(
            serve.poll if serve else "park",
            serve.spin_us * 1e-6 if serve else 50e-6)
        self._recurrent = cfg.family in ("ssm", "hybrid")
        self.prefills = 0
        self.admit_prefills = 0
        self.decode_steps = 0
        self.admission_hook = None
        self.admission_gate = None
        if serve is not None:
            self.step = dispatch.make_serve_step(
                cfg, serve.comm, ring=ring, channel_indices=channel_indices,
                pod_axis=serve.pod_axis if serve.pods > 1 else None)
            self._prefill = self.step.prefill
            self._decode = self.step.decode
            self.n_shards = self.step.n_shards
        else:
            self.step = None
            self.n_shards = 1
            self._prefill = lambda p, b: api.prefill(p, b, cfg)
            self._decode = lambda p, c, b: api.decode_step(p, c, b, cfg)

    # -- batching ------------------------------------------------------

    def _buckets(self, reqs: Sequence[Request]) -> list:
        """Recurrent families: buckets of equal prompt length (no pads),
        at most ``max_batch`` each, shortest length first."""
        groups = defaultdict(list)
        for r in reqs:
            groups[len(r.prompt)].append(r)
        return [rs[i:i + self.max_batch]
                for _, rs in sorted(groups.items())
                for i in range(0, len(rs), self.max_batch)]

    # -- sampling ------------------------------------------------------

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> torch.Tensor:
        greedy = torch.argmax(logits, dim=-1)
        if not (temps > 0).any():
            return greedy
        t = torch.as_tensor(np.maximum(temps, 1e-6), dtype=torch.float32,
                            device=logits.device)
        probs = torch.softmax(logits.float() / t[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        hot = torch.as_tensor(temps > 0, device=logits.device)
        return torch.where(hot, sampled, greedy)

    # -- main entry ----------------------------------------------------

    def generate(self, reqs: Sequence[Request]) -> list:
        reqs = list(reqs)
        results: list = []
        if self._recurrent:
            # one wave per equal-length bucket, no mid-flight admission
            # (the recurrence has no pad-exactness to admit against)
            for bucket in self._buckets(reqs):
                results.extend(self._run_wave(bucket, deque()))
        elif reqs:
            pending = deque(reqs[self.max_batch:])   # the run queue
            results.extend(self._run_wave(reqs[: self.max_batch], pending))
        results.sort(key=lambda r: r.uid)
        return results

    def _prefill_batch(self, toks: np.ndarray, lens: np.ndarray) -> dict:
        """Tokens, ``last_pos`` (attention families) and the stub
        frontends' zero frames or patches (encdec, vlm)."""
        dev = self.device
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.long,
                                           device=dev),
                 **api.stub_inputs(self.cfg, toks.shape[0], dev)}
        if not self._recurrent:
            batch["last_pos"] = torch.as_tensor(np.maximum(lens - 1, 0),
                                                dtype=torch.long, device=dev)
        return batch

    def _check_fits(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(f"request {req.uid}: prompt {len(req.prompt)} "
                             f"+ max_new {req.max_new} exceeds engine "
                             f"max_len {self.max_len}")

    # -- the slot loop -------------------------------------------------

    def _run_wave(self, initial: list, pending: deque) -> list:
        b = len(initial)
        R = self.n_shards
        b_pad = max(R, -(-b // R) * R)    # rows padded to the ring size
        for r in initial:
            self._check_fits(r)
        lens = np.zeros((b_pad,), np.int32)
        for i, r in enumerate(initial):
            lens[i] = len(r.prompt)
        toks = np.zeros((b_pad, int(lens.max())), np.int32)
        for i, r in enumerate(initial):
            toks[i, : lens[i]] = r.prompt

        if obs_trace.enabled():
            with obs_trace.span("prefill", f"wave_b{b}", batch=b,
                                pad_to=toks.shape[1]):
                logits, cache = self._prefill(
                    self.params, self._prefill_batch(toks, lens))
                self.prefills += 1
                self.poller.wait(logits)
        else:
            logits, cache = self._prefill(self.params,
                                          self._prefill_batch(toks, lens))
            self.prefills += 1
            self.poller.wait(logits)
        cache = api.grow_cache(self.cfg, cache, self.max_len)

        slots: list = [_Slot(r, 0, []) for r in initial] + [None] * (b_pad - b)
        temps = np.zeros((b_pad,), np.float32)
        for i, r in enumerate(initial):
            temps[i] = r.temperature
        pos = torch.as_tensor(lens, dtype=torch.long, device=self.device)
        tok = self._sample(logits, temps)
        steps = 0
        results: list = []

        while True:
            if obs_trace.enabled():
                with obs_trace.span("boundary", f"step{steps}", step=steps):
                    self._boundary(tok, slots, steps, results, pending)
            else:
                self._boundary(tok, slots, steps, results, pending)
            steps += 1
            # continuous batching: refill freed slots from the run queue
            if pending:
                tok, cache, pos = self._admit_ready(
                    pending, cache, pos, temps, tok, steps, slots, results)
            if not any(s is not None for s in slots) and not pending:
                break
            live = [s is not None for s in slots]
            active = torch.as_tensor(live, device=self.device)
            dec = {"token": tok, "pos": pos}
            if obs_trace.enabled():
                with obs_trace.span("decode", f"step{steps}", step=steps,
                                    active=sum(live)):
                    logits, cache = self._decode(self.params, cache, dec)
            else:
                logits, cache = self._decode(self.params, cache, dec)
            self.decode_steps += 1
            tok = self._sample(logits, temps)
            pos = torch.where(active, pos + 1, pos)
        return results

    def _boundary(self, tok: torch.Tensor, slots: list, steps: int,
                  results: list, pending: deque) -> None:
        """The flush boundary before step ``steps + 1``: wait for the
        sampled tokens (this step's work is complete once they are
        ready), read them back, retire finished slots into ``results``,
        then the fault window and the admission gate."""
        self.poller.wait(tok)
        tok_np = tok.cpu().numpy()
        for i, s in enumerate(slots):
            if s is None:
                continue
            if s.req.max_new > 0:    # max_new=0: prefill-only, no token
                s.toks.append(int(tok_np[i]))
                if self.eos_id is not None and s.toks[-1] == self.eos_id:
                    s.done = True
            if len(s.toks) >= s.req.max_new:
                s.done = True
            if s.done:
                results.append(Result(
                    uid=s.req.uid, tokens=np.asarray(s.toks, np.int64),
                    prompt_len=len(s.req.prompt),
                    steps=steps + 1 - s.admitted_step))
                slots[i] = None
        # the flush-boundary fault window: requests injected here enter
        # the run queue like any client's and take the same admission
        # path (exactness is per row); the gate sees the burst AFTER the
        # hook, so supervisor backpressure composes with chaos storms
        if not self._recurrent and (self.admission_hook is not None
                                    or self.admission_gate is not None):
            extra = list(self.admission_hook(self, steps + 1) or []) \
                if self.admission_hook is not None else []
            if self.admission_gate is not None:
                extra = self.admission_gate(self, steps + 1, extra)
            if extra:
                pending.extend(extra)

    def _admit_ready(self, pending: deque, cache: dict, pos: torch.Tensor,
                     temps: np.ndarray, tok: torch.Tensor, steps: int,
                     slots: list, results: list):
        """Admit from the run queue into EVERY freed slot at this flush
        boundary, one batched prefill per round. Loops because a request
        finishing AT admission (eos / max_new <= 1) leaves its slot free
        for the next queued request within the same boundary."""
        while pending:
            free = [i for i in range(min(len(slots), self.max_batch))
                    if slots[i] is None]
            if not free:
                break
            take = min(len(free), len(pending))
            batch = [pending.popleft() for _ in range(take)]
            if obs_trace.enabled():
                with obs_trace.span("admission", f"admit{take}", n=take,
                                    step=steps):
                    tok, cache, pos = self._admit_batch(
                        free[:take], batch, cache, pos, temps, tok, steps,
                        slots, results)
            else:
                tok, cache, pos = self._admit_batch(
                    free[:take], batch, cache, pos, temps, tok, steps,
                    slots, results)
        return tok, cache, pos

    def _admit_batch(self, free: list, reqs: list, cache: dict,
                     pos: torch.Tensor, temps: np.ndarray, tok: torch.Tensor,
                     steps: int, slots: list, results: list):
        """Attention families only. Admit ``reqs[j]`` into freed slot
        ``free[j]`` with ONE prefill
        (rows padded to the ring size, prompts right-padded to the batch
        max rounded up to ``ADMIT_PAD``). Each request's first token is
        sampled from its own prefill logits and recorded at once; a
        request done at its first token finishes here and leaves the slot
        free. Mutates ``temps``/``slots``/``results``; returns the new
        (tok, cache, pos)."""
        R = self.n_shards
        rows = max(R, -(-len(reqs) // R) * R)
        for req in reqs:
            self._check_fits(req)
        # round for a bounded set of shapes, but never past the resident
        # cache's sequence capacity (max_len, or the rolling window)
        limit = self.max_len
        if self.cfg.sliding_window:
            limit = min(limit, self.cfg.sliding_window)
        pmax = max(len(req.prompt) for req in reqs)
        pad_to = min(-(-pmax // ADMIT_PAD) * ADMIT_PAD, max(pmax, limit))
        toks = np.zeros((rows, pad_to), np.int32)
        lens = np.zeros((rows,), np.int32)
        rtemps = np.zeros((rows,), np.float32)
        for row, req in enumerate(reqs):
            toks[row, :len(req.prompt)] = req.prompt
            lens[row] = len(req.prompt)
            rtemps[row] = req.temperature
        logits1, cache1 = self._prefill(self.params,
                                        self._prefill_batch(toks, lens))
        self.prefills += 1
        self.admit_prefills += 1
        self.poller.wait(logits1)
        t_arr = self._sample(logits1, rtemps)
        t_np = t_arr.cpu().numpy()
        live_rows: list = []
        live_slots: list = []
        for row, (i, req) in enumerate(zip(free, reqs)):
            t0 = int(t_np[row])
            plen = int(lens[row])
            if req.max_new <= 0:          # prefill-only: zero tokens
                results.append(Result(uid=req.uid,
                                      tokens=np.asarray([], np.int64),
                                      prompt_len=plen, steps=0))
                continue
            if (self.eos_id is not None and t0 == self.eos_id) \
                    or req.max_new == 1:  # finished at its first token
                results.append(Result(uid=req.uid,
                                      tokens=np.asarray([t0], np.int64),
                                      prompt_len=plen, steps=1))
                continue
            live_rows.append(row)
            live_slots.append(i)
            temps[i] = req.temperature
            slots[i] = _Slot(req, steps, [t0])
        if live_rows:
            cache1 = api.grow_cache(self.cfg, cache1, self.max_len)
            rsel = torch.as_tensor(live_rows, device=self.device)
            ssel = torch.as_tensor(live_slots, device=self.device)
            # attention caches carry batch at axis 1 (L, B, S, KV, Dh),
            # encdec's nested self-attention and cross K/V too; the
            # freed rows are overwritten in place
            new = dict(tree_paths(cache1))
            for path, c in tree_paths(cache):
                c[:, ssel] = new[path][:, rsel]
            tok = tok.clone()
            tok[ssel] = t_arr[rsel]
            pos = pos.clone()
            pos[ssel] = torch.as_tensor(lens, dtype=torch.long,
                                        device=self.device)[rsel]
        return tok, cache, pos


# ---------------------------------------------------------------------------
# Event-loop glue: one engine per loop, channel affinity baked in
# ---------------------------------------------------------------------------


def make_engine_group(cfg: Any, params: Any, serve: ServeConfig, *,
                      eos_id: Optional[int] = None, seed: int = 0,
                      device: DeviceLike = None, ring: Optional[Ring] = None,
                      affinity: Optional[tuple] = None) -> EventLoopGroup:
    """The serving front door: an :class:`EventLoopGroup` of
    ``serve.event_loops`` loops, each owning a disjoint contiguous run of
    the ``serve.comm.channels`` pool and driving its OWN
    :class:`DecodeEngine` (generator seeded ``seed + loop index``) whose
    serve step emits only on those channels. Every loop shares ``ring``
    (None = one peer, no process group). Requests submitted to the group
    are assigned round-robin; GREEDY outputs do not depend on
    ``event_loops``.

    ``affinity`` overrides the computed partition with an explicit one,
    checked to be a partition of the pool into ``serve.event_loops``
    nonempty disjoint groups (the elastic reshard's minimal-migration
    partition, ``launch/elastic.reshard_affinity``, is deliberately not
    what ``channel_affinity`` would recompute).

    Multi-tenant form: with ``serve.tenants`` set, the loops are carved
    into contiguous per-tenant ranges in declaration order, and ``cfg``
    and ``params`` may EACH be a single value (every tenant serves the
    same model) or a dict keyed by tenant name (different models side
    by side: one group, one channel pool, an engine per range). The
    group routes ``Request.tenant`` to the owning range with
    weighted-fair dispatch (``EventLoopGroup``).

    Over a ring of more than one peer, drain the group inline
    (``run(threads=False)``): every peer must issue each loop's
    collectives in the same order, and threads sharing the ring's group
    would interleave them differently on each peer.

    With ``serve.pods > 1`` the group is TOPOLOGY-AWARE: ``ring`` must
    have that many pods on the axis ``serve.pod_axis`` (without a ring
    one is built over the default group: ``pods`` must divide its size),
    and under ``comm.hierarchical`` the computed affinity pins the pool's
    leader lanes to the first ``serve.leader_loops`` loops while each
    loop's local lanes stay in one pod block (``channel_affinity``'s
    topology form). The ring the loops share is ``group.ring``; one built
    here is the caller's to close."""
    dev = resolve_device(device)
    if serve.pods > 1:
        if ring is None:
            ring = Ring(channels=serve.comm.channels, pods=serve.pods,
                        pod_axis=serve.pod_axis)
        elif (ring.pods, ring.pod_axis) != (serve.pods, serve.pod_axis):
            raise ValueError(
                f"serve.pods={serve.pods} on axis {serve.pod_axis!r} does "
                f"not match the ring's {ring.pods} pods on axis "
                f"{ring.pod_axis!r}")
    if affinity is not None:
        affinity = tuple(tuple(g) for g in affinity)
        owned = sorted(c for g in affinity for c in g)
        if len(affinity) != serve.event_loops \
                or owned != list(range(serve.comm.channels)) \
                or any(not g for g in affinity):
            raise ValueError(
                f"explicit affinity {affinity} must partition channels "
                f"0..{serve.comm.channels - 1} into {serve.event_loops} "
                "nonempty disjoint groups")
    elif serve.pods > 1 and serve.comm.hierarchical:
        affinity = channel_affinity(
            serve.comm.channels, serve.event_loops, n_pods=serve.pods,
            leaders=min(serve.comm.leader_channels,
                        serve.comm.channels - 1),
            leader_loops=serve.leader_loops)
    else:
        affinity = channel_affinity(serve.comm.channels, serve.event_loops)
    bindings = []
    loop_tenant = {}
    start = 0
    for t in serve.tenants:
        ix = tuple(range(start, start + t.event_loops))
        bindings.append((t.name, t.weight, ix))
        for i in ix:
            loop_tenant[i] = t.name
        start += t.event_loops
    names = {t.name for t in serve.tenants}

    def resolve(v, what, always_dict=False):
        # params are a tree that is ITSELF a dict, so a dict is taken as
        # per-tenant only when its keys touch the tenant names
        per_tenant = isinstance(v, dict) and (
            always_dict or (names and set(v) & names))
        if not per_tenant:
            return lambda _name: v
        if not names:
            raise ValueError(
                f"{what} is a per-tenant dict but serve.tenants is empty: "
                "heterogeneous groups need named tenants to route by")
        if set(v) != names:
            raise ValueError(
                f"{what} keys {sorted(v)} must match the tenant names "
                f"{sorted(names)} exactly (one model binding per tenant)")
        return v.__getitem__

    cfg_of = resolve(cfg, "cfg", always_dict=True)
    params_of = resolve(params, "params")
    loops = []
    for i, chans in enumerate(affinity):
        name = loop_tenant.get(i, "")
        loop = EventLoop(i, channels=chans, poll=serve.poll,
                         spin_s=serve.spin_us * 1e-6)
        eng = DecodeEngine(cfg_of(name), params_of(name),
                           max_batch=serve.max_batch, max_len=serve.max_len,
                           eos_id=eos_id, seed=seed + i, serve=serve,
                           channel_indices=chans, poller=loop.poller,
                           device=dev, ring=ring)
        loop.engine = eng
        loop.runner = lambda _loop, items, eng=eng: eng.generate(items)
        loops.append(loop)
    return EventLoopGroup(loops, tenants=bindings or None, ring=ring)
