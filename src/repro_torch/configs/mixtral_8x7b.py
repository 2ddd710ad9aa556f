"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA. [arXiv:2401.04088; hf]

Sliding-window attention (4096): the decode KV cache is a rolling
window of 4096 slots.

Counterpart of ``repro/configs/mixtral_8x7b.py`` (same numbers).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    qkv_bias=False,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    source="arXiv:2401.04088; hf",
)
