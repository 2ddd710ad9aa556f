"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision frontend is a stub, as in the reference: the model takes
precomputed patch embeddings (batch, num_patches, d_model) and prepends
them to the text-token embeddings. anyres tiling: 5 tiles x 576
patches. The backbone is Mistral-7B (full attention in this checkpoint
lineage).

Counterpart of ``repro/configs/llava_next_mistral_7b.py`` (same
numbers).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
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
    num_patches=2880,          # 5 anyres tiles x 24x24 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
