"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1,
head_dim 256) d_ff=12288 vocab=256000 — RG-LRU + local attention, 1:2.
[arXiv:2402.19427; unverified]

Counterpart of ``repro/configs/recurrentgemma_9b.py`` (same numbers).
The block pattern cycles (rglru, rglru, local_attn); the 2048-token
local window bounds the decode state."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    lru_width=4096,
    source="arXiv:2402.19427; unverified",
)
