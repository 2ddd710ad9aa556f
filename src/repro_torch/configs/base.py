"""Configuration dataclasses of the port.

Counterpart of ``repro/configs/base.py``: the port keeps its own copy
(it imports nothing of ``repro``) with the fields the serving and
training slices read. ``reduced()`` derives the CPU-sized variant of a
config with the same rule as the reference, so every ``-reduced`` id has
the same shapes in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k experts. ``capacity_factor`` sizes each
    expert's per-row buffer (``models/moe.capacity``): tokens routed past
    it are dropped."""

    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (per-arch modules hold the numbers)."""

    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0         # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"  # swiglu | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    sliding_window: int = 0   # 0 -> full attention; >0 -> SWA window

    moe: Optional[MoEConfig] = None

    # hybrid (recurrentgemma): block pattern cycled over layers
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "local_attn")
    local_window: int = 2048
    lru_width: int = 0        # 0 -> d_model
    conv1d_width: int = 4     # temporal conv in the recurrent block

    # ssm (rwkv6)
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # encdec (whisper): encoder depth, and the frame count of the stub
    # frontend's (batch, num_frames, d_model) embeddings
    encoder_layers: int = 0
    num_frames: int = 1500

    # vlm (llava): patch-embedding prefix length (anyres: 5 tiles x 576)
    num_patches: int = 0

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    source: str = ""

    FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

    def __post_init__(self):
        if self.family not in self.FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("a moe config needs its MoEConfig")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(window) / O(1) rather than O(seq):
        the ssm and hybrid families, and sliding-window attention."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula term for term
        (final norm not counted; the hybrid's gate term is the
        reference's estimate, not the block-diagonal shapes)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = 5 * d * d                          # r,k,v,g,o projections
            per += d * self.rwkv_decay_lora * 2      # decay lora
            per += 5 * (d * self.rwkv_mix_lora * 2)  # token-shift mix loras
            per += 7 * d                             # mix biases, decay, bonus
            per += 2 * d * f + d * d                 # channel mix k, v, r
            per += 2 * d                             # norms
            return n + L * per
        att = d * (self.num_heads * hd) + d * (self.num_kv_heads * hd) * 2 \
            + (self.num_heads * hd) * d
        if self.qkv_bias:
            att += self.num_heads * hd + 2 * self.num_kv_heads * hd
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * f
        mlp_total = mlp
        if self.family == "moe":
            mlp_total = self.moe.num_experts * mlp + d * self.moe.num_experts
        if self.family == "hybrid":
            lw = self.lru_width or d
            rec = 2 * d * lw + lw * d + self.conv1d_width * lw + 3 * lw \
                + 2 * (lw * max(lw // 8, 1))
            pat = self.block_pattern or ("rglru",)
            n_attn = sum(1 for i in range(L)
                         if pat[i % len(pat)] == "local_attn")
            return n + n_attn * (att + mlp + 2 * d) \
                + (L - n_attn) * (rec + mlp + 2 * d)
        total = n + L * (att + mlp_total + 2 * d)
        if self.family == "encdec":
            # encoder layers, and one cross attention per decoder layer
            total += self.encoder_layers * (att + mlp + 2 * d)
            total += L * (att + d)
        return total

    def active_param_count(self) -> int:
        """Parameters one token runs through: the total less the experts
        it is not routed to (the reference's count: a swiglu expert's
        three matrices)."""
        if self.family != "moe":
            return self.param_count()
        inactive = self.num_layers * (self.moe.num_experts - self.moe.top_k) \
            * 3 * self.d_model * self.d_ff
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape: ``kind`` is train | prefill | decode."""

    name: str
    kind: str
    seq_len: int
    global_batch: int

    KINDS = ("train", "prefill", "decode")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown shape kind {self.kind!r}: expected "
                             f"one of {self.KINDS}")


# The reference's four input shapes (its assigned cells): every arch is
# paired with all four, and ``cell_skip_reason`` says which pairs skip.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_skip_reason(model: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """A reason string if (model, shape) is an assigned but skipped cell,
    else None: ``long_500k`` needs sub-quadratic attention (the
    reference's rule and words)."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return ("pure full attention: 500k-token decode requires a 500k KV "
                "cache and O(seq) attention per step — skipped per brief")
    return None


def cells_for(model: ModelConfig) -> list[ShapeConfig]:
    return [s for s in SHAPES.values() if cell_skip_reason(model, s) is None]


@dataclass(frozen=True)
class CommConfig:
    """The comm fields of the reference, with its defaults and checks.
    ``mode`` must name a registered backend
    (``repro_torch.core.backends.available_modes``).

    ``slice_bytes`` is the ring-buffer slice (one collective each) and
    ``ring_capacity_bytes`` bounds the slices in flight (more slices than
    that grow the slice). ``compress`` is the wire codec (bf16 and
    int8_ef carry an f32 error-feedback residual). ``pack`` picks the
    pack/unpack stage: ``pallas`` is the hand-written kernel (CUDA
    tensors; the plain version for CPU tensors), ``jnp`` that plain
    version on any device; both give the same bytes. ``aggregate`` is the
    flush granularity (one collective per slice, or one coalesced
    collective per channel) and ``flush`` the channel schedule
    (round-robin flushed at the end of the exchange, or contiguous
    groups flushed when their last slice is staged). ``hierarchical``
    turns on the pod-aware two-level collectives where the ring has a
    pod axis (``core/channels.Ring``), and ``leader_channels`` is how
    many lanes at the tail of the pool carry the cross-pod stage under
    channel-granularity flushes (clamped to ``channels - 1`` when the
    emission carves them, so a one-channel pool stays per-channel)."""

    mode: str = "gspmd"
    ring_capacity_bytes: int = 256 * 1024 * 1024
    slice_bytes: int = 4 * 1024 * 1024
    channels: int = 4                  # in-flight slices ("connections")
    compress: str = "none"             # none | bf16 | int8_ef
    pack: str = "jnp"                  # pack/unpack-stage impl: jnp | pallas
    aggregate: str = "slice"           # wire-flush granularity: slice | channel
    flush: str = "step"                # channel schedule: step | ready
    hierarchical: bool = True          # pod-aware two-level collectives
    leader_channels: int = 1           # channels carved for cross-pod traffic

    COMPRESS_CODECS = ("none", "bf16", "int8_ef")
    PACK_IMPLS = ("jnp", "pallas")
    AGGREGATES = ("slice", "channel")
    FLUSHES = ("step", "ready")

    def __post_init__(self):
        from repro_torch.core.backends import available_modes
        if self.mode not in available_modes():
            raise ValueError(f"unknown comm mode {self.mode!r}; registered: "
                             f"{available_modes()}")
        if self.channels < 1:
            raise ValueError(
                f"comm.channels must be >= 1 (got {self.channels}): the "
                "connection pool needs at least one channel; values above "
                "n_slices are clamped to fully-independent emission")
        if self.compress not in self.COMPRESS_CODECS:
            raise ValueError(
                f"unknown comm.compress {self.compress!r}: expected one of "
                f"{self.COMPRESS_CODECS}")
        if self.pack not in self.PACK_IMPLS:
            raise ValueError(
                f"unknown comm.pack {self.pack!r}: expected one of "
                f"{self.PACK_IMPLS}")
        if self.aggregate not in self.AGGREGATES:
            raise ValueError(
                f"unknown comm.aggregate {self.aggregate!r}: expected one "
                f"of {self.AGGREGATES} ('channel' coalesces every slice on "
                "a channel into one wire flush per collective)")
        if self.flush not in self.FLUSHES:
            raise ValueError(
                f"unknown comm.flush {self.flush!r}: expected one of "
                f"{self.FLUSHES} ('ready' emits each channel's flush the "
                "moment its last assigned bucket is staged; 'step' flushes "
                "every channel at one end-of-exchange loop)")
        if self.leader_channels < 1:
            raise ValueError(
                f"comm.leader_channels must be >= 1 (got "
                f"{self.leader_channels}): the cross-pod stage of the "
                "hierarchical emission needs at least one dedicated lane; "
                "values >= comm.channels are clamped to channels-1 at "
                "emission time (a 1-channel pool has no lane to carve)")
        if not 0 < self.slice_bytes <= self.ring_capacity_bytes:
            raise ValueError(
                f"comm.slice_bytes must be > 0 and <= ring_capacity_bytes "
                f"(got {self.slice_bytes}, {self.ring_capacity_bytes})")


@dataclass(frozen=True)
class TenantConfig:
    """One tenant of a multi-tenant ``EventLoopGroup``: a named model
    sharing the group's channel pool with the others. Tenants partition
    ``serve.event_loops`` into disjoint contiguous loop ranges
    (declaration order), so channel ownership stays disjoint per loop
    and per tenant; ``weight`` is the tenant's share of the group's
    weighted-fair dispatch (``serving/event_loop.EventLoopGroup``)."""

    name: str                          # unique tenant key (Request.tenant)
    arch: str = ""                     # registry arch served for this tenant
    weight: int = 1                    # weighted-fair dispatch share
    event_loops: int = 1               # loops owned by this tenant


@dataclass(frozen=True)
class ServeConfig:
    """Event-loop serving: ``event_loops`` loops, each owning a disjoint
    contiguous run of the ``comm.channels`` pool, with ``max_batch``
    decode slots per loop. ``poll``: ``busy`` spins on completion,
    ``park`` blocks, ``adaptive`` spins for ``spin_us`` then parks.
    ``tenants`` (:class:`TenantConfig`) partition the loops among named
    models; the reference's error texts are kept.

    ``pods`` is the two-level serving fabric: the ring becomes ``pods``
    pods of ``ring size // pods`` peers over ``(pod_axis, "data")``
    (``core/channels.Ring``), and with ``comm.hierarchical`` in-pod
    traffic rides the local lanes while only the in-pod-reduced shards
    cross pods on the ``comm.leader_channels`` leader lanes, pinned to
    the first ``leader_loops`` event loops. That ``pods`` divides the
    ring size is checked where the ring is known (``Ring``)."""

    event_loops: int = 1
    poll: str = "busy"
    spin_us: float = 50.0
    max_batch: int = 8
    max_len: int = 256
    comm: CommConfig = field(default_factory=CommConfig)
    pods: int = 1                      # two-level fabric: pod count
    pod_axis: str = "pod"              # the ring's name for the pod axis
    leader_loops: int = 1              # loops pinned to the leader lanes
    tenants: tuple = ()                # TenantConfig partition of the loops

    POLLS = ("busy", "park", "adaptive")

    def __post_init__(self):
        if self.event_loops < 1:
            raise ValueError(
                f"serve.event_loops must be >= 1 (got {self.event_loops})")
        if self.poll not in self.POLLS:
            raise ValueError(
                f"unknown serve.poll {self.poll!r}: expected one of "
                f"{self.POLLS} (busy spins, park blocks, adaptive spins "
                "for spin_us then parks)")
        if self.event_loops > self.comm.channels:
            raise ValueError(
                f"serve.event_loops={self.event_loops} exceeds "
                f"comm.channels={self.comm.channels}: each event loop "
                "must OWN a disjoint non-empty run of the channel pool")
        if self.spin_us < 0:
            raise ValueError(f"serve.spin_us must be >= 0 ({self.spin_us})")
        if self.max_batch < 1 or self.max_len < 2:
            raise ValueError("serve.max_batch must be >= 1 and "
                             "serve.max_len >= 2")
        if self.pods < 1:
            raise ValueError(f"serve.pods must be >= 1 (got {self.pods})")
        if not self.pod_axis:
            raise ValueError("serve.pod_axis must be a non-empty axis name")
        if not 1 <= self.leader_loops <= self.event_loops:
            raise ValueError(
                f"serve.leader_loops={self.leader_loops} must be in "
                f"[1, event_loops={self.event_loops}]: leader channels are "
                "pinned to a designated subset of the loops, and at least "
                "one loop must carry the cross-pod lanes")
        if self.pods > 1 and self.comm.hierarchical:
            if self.comm.leader_channels >= self.comm.channels:
                raise ValueError(
                    f"comm.leader_channels={self.comm.leader_channels} must "
                    f"be < comm.channels={self.comm.channels} when serving "
                    f"{self.pods} pods hierarchically: carving every lane "
                    "for cross-pod traffic leaves no local lane for the "
                    "in-pod stages (raise comm.channels or lower "
                    "leader_channels)")
            if self.event_loops > self.comm.channels - self.comm.leader_channels:
                raise ValueError(
                    f"serve.event_loops={self.event_loops} exceeds the "
                    f"{self.comm.channels - self.comm.leader_channels} "
                    f"LOCAL channels (channels={self.comm.channels} minus "
                    f"leader_channels={self.comm.leader_channels}): under "
                    "the two-level fabric every loop must own at least one "
                    "local lane for its in-pod stages")
        if self.tenants:
            names = [t.name for t in self.tenants]
            if any(not n for n in names) or len(set(names)) != len(names):
                raise ValueError(
                    f"serve.tenants names must be unique and non-empty "
                    f"(got {names!r}): Request.tenant routes by name")
            for t in self.tenants:
                if t.weight < 1:
                    raise ValueError(
                        f"tenant {t.name!r}: weight must be >= 1 (got "
                        f"{t.weight}) — zero-weight tenants would starve")
                if t.event_loops < 1:
                    raise ValueError(
                        f"tenant {t.name!r}: event_loops must be >= 1 (got "
                        f"{t.event_loops}): every tenant needs at least one "
                        "loop, hence at least one owned channel")
            total = sum(t.event_loops for t in self.tenants)
            if total != self.event_loops:
                raise ValueError(
                    f"serve.tenants pin the fleet size: per-tenant "
                    f"event_loops sum to {total} but serve.event_loops="
                    f"{self.event_loops}. Tenant loop ranges are a static "
                    "partition of the group, so supervisor autoscaling "
                    "requires tenants=()")


@dataclass(frozen=True)
class RunConfig:
    """What the trainer needs beyond the model: the reference's
    optimizer, gradient accumulation, checkpointing and restart, data and
    seed fields, with its defaults. ``microbatches`` splits each peer's
    batch for gradient accumulation; ``checkpoint_dir`` (empty: no
    checkpoints) receives a checkpoint every ``checkpoint_every`` steps
    and at the end, the last ``keep_checkpoints`` kept, written on a
    thread when ``async_checkpoint``; ``max_restarts`` bounds the
    supervision loop (``launch/train.train_with_restarts``)."""

    model: ModelConfig
    shape: ShapeConfig
    comm: CommConfig = field(default_factory=CommConfig)

    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1              # gradient accumulation

    # checkpointing / fault tolerance
    checkpoint_dir: str = ""
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    max_restarts: int = 100

    # data
    data_path: str = ""                # empty -> synthetic
    data_seed: int = 0

    seed: int = 0


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The CPU-sized variant: same family and topology, tiny dims, f32 —
    the rule of ``repro.configs.base.reduced`` (a hybrid keeps two full
    block-pattern groups and no tail; a moe config keeps at most 4
    experts and top-2, with ``capacity_factor`` equal to its expert
    count, so no token is dropped; an encdec config keeps at most 2
    encoder layers and 8 frames, a vlm config at most 8 patches)."""
    num_heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    moe = None
    if cfg.moe is not None:
        e = min(cfg.moe.num_experts, 4)
        moe = MoEConfig(num_experts=e, top_k=min(cfg.moe.top_k, 2),
                        capacity_factor=float(e))
    return replace(
        cfg, name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 2 * len(cfg.block_pattern)
                       if cfg.block_pattern else 4),
        d_model=64, num_heads=num_heads,
        num_kv_heads=max(1, min(cfg.num_kv_heads, num_heads))
        if num_heads else 0,
        head_dim=16 if num_heads else 0, d_ff=128, vocab_size=256,
        lru_width=64 if cfg.family == "hybrid" else 0,
        rwkv_head_size=16, rwkv_decay_lora=8, rwkv_mix_lora=8,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window
        else 0,
        local_window=16, moe=moe,
        encoder_layers=min(cfg.encoder_layers, 2), num_frames=8,
        num_patches=min(cfg.num_patches, 8),
        param_dtype="float32", compute_dtype="float32")

