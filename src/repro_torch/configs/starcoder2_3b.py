"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]

StarCoder2 uses LayerNorm + plain (non-gated) GELU MLP and biases.

Counterpart of ``repro/configs/starcoder2_3b.py`` (same numbers).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=999_999.4,
    source="arXiv:2402.19173; hf",
)
