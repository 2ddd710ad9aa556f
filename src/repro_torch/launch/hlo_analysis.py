"""The analysis layer: collective counts and bytes, FLOPs, memory and the
roofline terms, read off the port's issued op stream.

Counterpart of ``repro/launch/hlo_analysis.py``, with its names. The
reference parses the (Stable)HLO text XLA emits for a jitted step. The
port emits no HLO: eager PyTorch issues its ops one at a time, so
:func:`record` watches that stream with a ``TorchDispatchMode`` and
yields an :class:`OpLog` — every ``aten`` op and every ``c10d``
collective, in issue order — which the reference's readers take in
place of the text. A DTensor op (the gspmd step over a ``DeviceMesh``)
is logged as what it issues: the ops on its local blocks and the
functional collectives (``_c10d_functional``) of its redistributions:

* :func:`collective_stats` — op counts and RESULT bytes per collective
  kind (the reference counts result-type bytes). It stands for both
  ``stablehlo_collective_stats`` (what the program emits) and
  ``collective_stats`` (what the compiled module runs): eager PyTorch
  has no combiner pass between the two, so issued equals emitted.
* :func:`cross_pod_collective_count` — each reduce or gather collective
  in-pod or cross-pod from its group's global ranks (rank ``m`` is in
  pod ``m // in_pod_size``: the rings are pod-major).
* :func:`first_collective_position` — ``(first, total)`` over the
  logged ops, or None when nothing is issued.
* :func:`flops_and_bytes` — FLOPs from ``FlopCounterMode``, and
  ``bytes_accessed``: operand plus result bytes over the logged ``aten``
  ops. That is the same pre-fusion count as XLA's ``bytes accessed``,
  and as unusable for a roofline: every view and every elementwise op
  counts its operands again. ``transcendentals`` and
  ``optimal_seconds`` have no counterpart and are absent, not zero.
* :func:`memory_stats` — on the card, the caching allocator's peak
  around one call; on fake or CPU tensors, ``MemTracker``'s estimate;
  under the reference's key names where they mean the same thing.

Only analysis callers arm the recorder (the dry run, tests,
``chip_smoke.py``); the serve and train paths never run under it. The
hand-written kernels are launched through ``ctypes``
(``kernels/build.py``), not through the dispatcher, so they are not in
the log (their wrappers' output allocations are); their wrappers'
launch counters count them.

``roofline_terms``, ``analytic_hbm_bytes`` and ``model_flops`` are the
reference's arithmetic, with the card's figures. Hardware model: one
NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 data sheet, not measured:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and
NVLink 4 at 900 GB/s per GPU in both directions together, 450 GB/s one
way. A number derived from them is written beside the name and power
limit of the card it is compared with. The reference's HLO and
StableHLO text parsers are not carried over: the port has no such text.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (H100 SXM data sheet)
ICI_BW = 450e9               # bytes/s per direction, NVLink 4 (900 GB/s
#                              bidirectional per GPU, H100 SXM data sheet)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d dispatcher ops -> the reference's kind names. The port issues no
# point-to-point traffic, so nothing maps to collective-permute.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}

# functional collectives (DTensor's redistributions) -> kind names
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# the kinds the two-level fabric decomposes (an all-to-all carries
# source-target traffic over the whole ring and never rides leader lanes)
_POD_KINDS = ("all-reduce", "all-gather", "reduce-scatter")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@dataclass(frozen=True)
class Op:
    """One issued op: ``name`` (``aten.mm.default``,
    ``c10d.allreduce_.default``), the collective ``kind`` (None for an
    ``aten`` op), ``nbytes`` (a collective's result bytes; an ``aten``
    op's operand plus result bytes) and a collective's group as global
    ``ranks``."""
    name: str
    kind: Optional[str] = None
    nbytes: int = 0
    ranks: tuple = ()


class OpLog(list):
    """The ops issued under :func:`record`, in issue order."""

    @property
    def collectives(self) -> list:
        return [op for op in self if op.kind is not None]


def _group_ranks(args) -> tuple:
    """Global ranks of the process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return tuple(dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(a)))
    return ()


def _functional_ranks(args) -> tuple:
    """Global ranks of a functional collective's group (its name is the
    op's last string argument)."""
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return ()
    group = dist.distributed_c10d._resolve_process_group(names[-1])
    return tuple(dist.get_process_group_ranks(group))


class _Recorder(TorchDispatchMode):

    def __init__(self, log: OpLog):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op on its local blocks and issues its
            # redistributions' collectives: those reach this mode
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _FUNCTIONAL_KINDS.get(func._opname)
            if kind:
                self.log.append(Op(str(func), kind, _nbytes(tree_leaves(out)),
                                   _functional_ranks(args)))
        elif ns == "c10d":
            kind = _C10D_KINDS.get(func._opname)
            # the first argument is the result: the in-place tensors of
            # an all-reduce, the output of the others
            self.log.append(Op(str(func), kind,
                               _nbytes(tree_leaves(args[0])) if kind else 0,
                               _group_ranks(args) if kind else ()))
        elif ns == "aten":
            self.log.append(Op(str(func), None, _nbytes(
                tree_leaves((args, kwargs))) + _nbytes(tree_leaves(out))))
        return out


@contextlib.contextmanager
def record():
    """``with record() as log:`` — every ``aten`` op and ``c10d``
    collective issued inside, appended to ``log`` (an :class:`OpLog`)."""
    log = OpLog()
    with _Recorder(log):
        yield log


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)     # kind -> op count
    bytes_: dict = field(default_factory=dict)     # kind -> result bytes

    @property
    def total_ops(self) -> int:
        return sum(self.counts.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_.values())

    def as_dict(self) -> dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes_),
                "total_ops": self.total_ops, "total_bytes": self.total_bytes}


def collective_stats(log: OpLog) -> CollectiveStats:
    """Collective op counts and result bytes per kind."""
    st = CollectiveStats()
    for op in log.collectives:
        st.counts[op.kind] = st.counts.get(op.kind, 0) + 1
        st.bytes_[op.kind] = st.bytes_.get(op.kind, 0) + op.nbytes
    return st


def cross_pod_collective_count(log: OpLog, in_pod_size: int) -> dict:
    """Classify every issued reduce or gather collective as IN-POD or
    CROSS-POD, the reference's evidence of the two-level fabric: member
    ``m`` of a group lives in pod ``m // in_pod_size`` (global ranks,
    pod-major), and a collective is cross-pod iff its group spans two
    pods. Under the leader emission the cross-pod count per exchange
    drops from the pool's lanes to its leader lanes; the flat schedule
    keeps every collective cross-pod.

    Returns ``{"in_pod": {kind: n}, "cross_pod": {kind: n},
    "in_pod_total": int, "cross_pod_total": int}``."""
    if in_pod_size < 1:
        raise ValueError(f"in_pod_size must be >= 1, got {in_pod_size}")
    out = {"in_pod": {}, "cross_pod": {}}
    for op in log.collectives:
        if op.kind not in _POD_KINDS or not op.ranks:
            continue
        cross = len({m // in_pod_size for m in op.ranks}) > 1
        side = "cross_pod" if cross else "in_pod"
        out[side][op.kind] = out[side].get(op.kind, 0) + 1
    out["in_pod_total"] = sum(out["in_pod"].values())
    out["cross_pod_total"] = sum(out["cross_pod"].values())
    return out


def first_collective_position(log: OpLog):
    """Emission-position evidence: ``(first, total)`` where ``first`` is
    the index of the first collective among the logged ops and ``total``
    their count — or None when no collective was issued (a local decode
    step has no emission position, and callers must not treat a
    sentinel as one)."""
    for i, op in enumerate(log):
        if op.kind is not None:
            return i, len(log)
    return None


@dataclass
class Profile:
    """One call under :func:`profile`: its result, op log, counted
    FLOPs and memory (:func:`memory_stats`'s keys; empty when not
    asked for)."""
    out: Any
    log: OpLog
    flops: float
    memory: dict


def _storages(tree) -> dict:
    """{storage id: bytes} of the tensors in ``tree`` (a DTensor's: its
    local block's)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def profile(fn: Callable, *args, memory: bool = True, **kwargs) -> Profile:
    """Run ``fn(*args, **kwargs)`` once under the recorder and
    ``FlopCounterMode`` (and, with ``memory``, the memory probe of
    :func:`memory_stats`)."""
    from torch.utils.flop_counter import FlopCounterMode
    arg_st = _storages((args, kwargs))
    tensors = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
    on_card = bool(tensors) and tensors[0].device.type == "cuda" and \
        not isinstance(tensors[0], torch._subclasses.FakeTensor)
    with contextlib.ExitStack() as stack:
        flop = stack.enter_context(FlopCounterMode(display=False))
        log = stack.enter_context(record())
        tracker = None
        if memory and on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        elif memory:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            tracker.track_external(*tensors)
            stack.enter_context(tracker)
            before = sum(arg_st.values())
        out = fn(*args, **kwargs)
        if memory and on_card:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
    mem = {}
    if memory:
        if tracker is not None:
            peak = sum(v["Total"] for v in
                       tracker.get_tracker_snapshot("peak").values())
        out_st = _storages(out)
        alias = sum(b for k, b in out_st.items() if k in arg_st)
        output = sum(out_st.values())
        mem = {"argument_size_in_bytes": sum(arg_st.values()),
               "output_size_in_bytes": output,
               "alias_size_in_bytes": alias,
               "temp_size_in_bytes": max(0, peak - before
                                         - (output - alias)),
               "peak_size_in_bytes": peak}
    return Profile(out, log, float(flop.get_total_flops()), mem)


def flops_and_bytes(fn: Callable, *args, **kwargs) -> dict:
    """``{"flops", "bytes_accessed"}`` of one call (module docstring)."""
    p = profile(fn, *args, memory=False, **kwargs)
    return costs(p)


def costs(p: Profile) -> dict:
    """A profiled call's ``flops`` and pre-fusion ``bytes_accessed``."""
    return {"flops": p.flops,
            "bytes_accessed": float(sum(op.nbytes for op in p.log
                                        if op.kind is None))}


def memory_stats(fn: Callable, *args, **kwargs) -> dict:
    """Memory of one call, in the reference's keys where they mean the
    same: ``argument_size_in_bytes`` and ``output_size_in_bytes`` (the
    distinct storages of the arguments and of the result),
    ``alias_size_in_bytes`` (result storages that are argument storages:
    an in-place update), ``temp_size_in_bytes`` (the peak above the
    bytes live at the call, less the new outputs), and the port's own
    ``peak_size_in_bytes``. On the card the peak is the caching
    allocator's ``max_memory_allocated`` (every tensor live on the card
    counts in it); on fake or CPU tensors, ``MemTracker``'s peak over
    the arguments and what the call allocates."""
    return profile(fn, *args, **kwargs).memory


def roofline_terms(*, flops: float, hbm_bytes: float,
                   collective_bytes: float, n_chips: int,
                   flops_are_global: bool = True,
                   hbm_is_global: bool | None = None) -> dict:
    """The three roofline terms, in seconds. The collective term uses
    one link's bandwidth per direction; ``collective_bytes`` of one peer
    is already per-card traffic. ``hbm_is_global`` defaults to
    ``flops_are_global`` (counted numbers are per card together; the
    analytic model passes flops globally but bytes per card)."""
    if hbm_is_global is None:
        hbm_is_global = flops_are_global
    compute_s = flops / ((n_chips if flops_are_global else 1) * PEAK_FLOPS)
    memory_s = hbm_bytes / ((n_chips if hbm_is_global else 1) * HBM_BW)
    collective_s = collective_bytes / ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms


def analytic_hbm_bytes(cfg, shape, n_chips: int, *, tp: int = 16,
                       dp: int = 16) -> float:
    """Analytic per-card HBM traffic per step (bytes), the roofline
    memory term's numerator (the counted ``bytes_accessed`` counts every
    op's operands before fusion, so it cannot serve). A streaming lower
    bound: weights, activations, logits, and optimizer or cache
    traffic; the reference's model term for term."""
    p_bytes = cfg.param_count() * 2                    # bf16
    p_active = cfg.active_param_count() * 2
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    tokens = shape.global_batch * shape.seq_len
    tokens_chip = tokens / n_chips                     # batch/dp x seq/tp(SP)
    tokens_row = tokens / dp                           # per data-shard row

    if shape.kind == "train":
        # weights: fwd read + remat re-read + bwd read of the TP shard
        w = 3.0 * p_bytes / tp
        # activations: residual+attn+mlp streams, ~6 passes of (tok, d)
        act = 6.0 * tokens_chip * d * 2 * L
        # logits: f32 write + read (CE) + bwd of the vocab/model shard
        logits = 3.0 * tokens_row * (V / tp) * 4
        # optimizer: grads f32 rw + two moments rw + param rw, sharded
        opt = (4 + 16 + 4) * (cfg.param_count() / n_chips)
        return w + act + logits + opt
    if shape.kind == "prefill":
        w = 1.0 * p_active / tp
        act = 4.0 * tokens_chip * d * 2 * L
        kv = 2.0 * tokens_chip * cfg.num_kv_heads * cfg.head_dim * 2 * L \
            if cfg.num_heads else 2.0 * tokens_chip * d * 2
        return w + act + kv
    # decode: every active weight shard read once; cache read + write
    w = 1.0 * p_active / tp
    eff = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
        else shape.seq_len
    if cfg.family == "ssm":
        hs = cfg.rwkv_head_size
        cache = (d // hs) * hs * hs * 4 * L * shape.global_batch
    elif cfg.family == "hybrid":
        lw = cfg.lru_width or d
        n_attn = sum(1 for i in range(L) if cfg.block_pattern[
            i % len(cfg.block_pattern)] == "local_attn")
        cache = (shape.global_batch
                 * (cfg.local_window * cfg.num_kv_heads * cfg.head_dim * 2
                    * n_attn + lw * 4 * (L - n_attn)))
    else:
        cache = (shape.global_batch * eff * cfg.num_kv_heads
                 * cfg.head_dim * 2 * 2 * L)
        if cfg.family == "encdec":
            cache += (shape.global_batch * cfg.num_frames
                      * cfg.num_kv_heads * cfg.head_dim * 2 * 2 * L)
    return w + 1.5 * cache / n_chips     # read whole cache + write 1 slot


def model_flops(cfg, shape, n_tokens: int | None = None) -> float:
    """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (moe) for a train step,
    with two refinements so the useful-compute ratio is honest: the
    token-embedding table does no matmul FLOPs (a lookup; only the LM
    head's V·d matmul counts, and it is already in N), and causal
    attention adds 12·L·H·dh·S_eff per token (S_eff the mean KV span) on
    top of the parameter matmuls. A counted step's FLOPs also hold the
    tied head's second matmul and the plain attention's full chunks,
    which this leaves out."""
    n_active = cfg.active_param_count()
    # remove the lookup-only embedding table from the matmul-param count
    n_matmul = n_active - cfg.vocab_size * cfg.d_model
    if n_tokens is None:
        n_tokens = shape.global_batch * shape.seq_len

    # attention score+value FLOPs per token per attention layer (fwd):
    # 2·(H·dh)·span for QK^T plus 2·(H·dh)·span for PV.
    h_dim = cfg.num_heads * cfg.head_dim if cfg.num_heads else 0
    if cfg.family == "hybrid" and cfg.block_pattern:
        n_attn = sum(1 for i in range(cfg.num_layers)
                     if cfg.block_pattern[i % len(cfg.block_pattern)]
                     == "local_attn")
        window = cfg.local_window
    elif cfg.family == "ssm":
        n_attn, window = 0, 0
    else:
        n_attn, window = cfg.num_layers, cfg.sliding_window

    def attn_flops_fwd(seq: float, causal_mean: bool) -> float:
        span = seq / 2 if causal_mean else seq
        if window:
            span = min(span, float(window))
        return 4.0 * h_dim * span * n_attn

    if shape.kind == "train":
        per_tok = 2.0 * n_matmul + attn_flops_fwd(shape.seq_len, True)
        return 3.0 * per_tok * n_tokens          # fwd + bwd = 3x fwd
    if shape.kind == "prefill":
        per_tok = 2.0 * n_matmul + attn_flops_fwd(shape.seq_len, True)
        return per_tok * n_tokens
    # decode: one token per sequence; attention spans the whole cache
    per_tok = 2.0 * n_matmul + attn_flops_fwd(shape.seq_len, False)
    return per_tok * shape.global_batch
