"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro/configs/registry.py``: every id of the
reference — the dense ``qwen2-0.5b``, ``qwen1.5-4b``, ``starcoder2-3b``
and ``qwen1.5-110b``, the moe ``mixtral-8x7b`` and ``dbrx-132b``, the
ssm ``rwkv6-7b``, the hybrid ``recurrentgemma-9b``, the encdec
``whisper-tiny`` and the vlm ``llava-next-mistral-7b``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

_ARCH_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-110b": "qwen1_5_110b",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x7b": "mixtral_8x7b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    """Resolve ``--arch`` ids; ``<id>-reduced`` yields the smoke variant."""
    want_reduced = arch.endswith("-reduced")
    base = arch[: -len("-reduced")] if want_reduced else arch
    if base not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[base]}")
    cfg: ModelConfig = mod.CONFIG
    return reduced(cfg) if want_reduced else cfg


__all__ = ["ARCH_IDS", "get_config", "reduced"]
