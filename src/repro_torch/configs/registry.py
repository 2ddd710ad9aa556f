"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro/configs/registry.py``: every id of the
reference — the dense ``qwen2-0.5b``, ``qwen1.5-4b``, ``starcoder2-3b``
and ``qwen1.5-110b``, the moe ``mixtral-8x7b`` and ``dbrx-132b``, the
ssm ``rwkv6-7b``, the hybrid ``recurrentgemma-9b``, the encdec
``whisper-tiny`` and the vlm ``llava-next-mistral-7b``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      cell_skip_reason, cells_for, describe,
                                      reduced)

_ARCH_MODULES = {    # the reference's order (``ARCH_IDS``, ``all_cells``)
    "qwen1.5-4b": "qwen1_5_4b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-110b": "qwen1_5_110b",
    "whisper-tiny": "whisper_tiny",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
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


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> list[tuple[ModelConfig, ShapeConfig, str | None]]:
    """Every (arch x shape) cell with its skip reason (None: it runs)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out.append((cfg, shape, cell_skip_reason(cfg, shape)))
    return out


__all__ = ["ARCH_IDS", "SHAPES", "all_cells", "cell_skip_reason",
           "cells_for", "describe", "get_config", "get_shape", "reduced"]
