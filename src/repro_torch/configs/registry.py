"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro/configs/registry.py``. Ported so far: the dense
``qwen2-0.5b``, ``qwen1.5-4b``, ``starcoder2-3b`` and ``qwen1.5-110b``,
the moe ``mixtral-8x7b`` and ``dbrx-132b``, the ssm ``rwkv6-7b`` and the
hybrid ``recurrentgemma-9b``; the reference's other ids (whisper's
encdec and llava's vlm) are known here and raise
``NotImplementedError`` naming the ROADMAP queue entry that brings
their family.
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
}

# reference ids whose family is not ported yet
_NOT_PORTED = ("whisper-tiny", "llava-next-mistral-7b")

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    """Resolve ``--arch`` ids; ``<id>-reduced`` yields the smoke variant."""
    want_reduced = arch.endswith("-reduced")
    base = arch[: -len("-reduced")] if want_reduced else arch
    if base in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP.md, "
            "Queue 1: 'The other model families')")
    if base not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[base]}")
    cfg: ModelConfig = mod.CONFIG
    return reduced(cfg) if want_reduced else cfg


__all__ = ["ARCH_IDS", "get_config", "reduced"]
