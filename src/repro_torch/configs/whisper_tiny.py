"""whisper-tiny [audio] — 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865
— encoder-decoder, conv frontend (stub). [arXiv:2212.04356; unverified]

The conv/mel frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (batch, num_frames=1500, d_model). Whisper
uses LayerNorm + GELU, learned positions (no RoPE) and biases.

Counterpart of ``repro/configs/whisper_tiny.py`` (same numbers).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,              # decoder layers
    encoder_layers=4,
    num_frames=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=0.0,            # 0 -> learned absolute positions
    source="arXiv:2212.04356; unverified",
)
