"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16e top-4, fine-grained. [hf:databricks/dbrx-base; unverified]

Counterpart of ``repro/configs/dbrx_132b.py`` (same numbers)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    qkv_bias=False,
    mlp_kind="swiglu",
    norm_kind="layernorm",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4),
    source="hf:databricks/dbrx-base; unverified",
)
