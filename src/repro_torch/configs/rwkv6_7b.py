"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; hf]

Counterpart of ``repro/configs/rwkv6_7b.py`` (same numbers). Decode
state is O(heads * head_size^2) per layer; head_size 64 -> 64 heads."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    norm_kind="layernorm",
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    source="arXiv:2404.05892; hf",
)
