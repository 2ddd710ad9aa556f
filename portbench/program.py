"""The program under test, as the harness sees it.

The measured package is the PyTorch and CUDA port, ``repro_torch``
under ``src/`` of the checkout. This module turns a configuration file
into the port's ``ModelConfig`` (its registry entry for the kinds of
layers, every number from the file), checks that the port's parameter
tree has the layout the benchmark's weights are made in, and checks
that the process never loaded JAX or the JAX package, whose top-level
name ``repro`` is a prefix of the port's: names are compared whole.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def add_src(root: Path) -> None:
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"the program is missing: no {src / 'repro_torch'} "
                         "in this checkout")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    the JAX package's or its benchmark folder's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def model_config(cfg: dict, param_dtype: str = ""):
    """The port's ModelConfig for a configuration file: the registry
    entry named by ``registry_id`` with every size, the window, the
    rotary base, the expert counts and the dtype taken from the file.
    ``param_dtype`` keeps the parameters in another type than the
    compute (a training job's float32 master weights)."""
    from repro_torch.configs.registry import get_config
    base = get_config(cfg["registry_id"])
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    moe = base.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=cfg["num_local_experts"],
            top_k=cfg["num_experts_per_tok"],
            capacity_factor=cfg["capacity_factor"])
    return dataclasses.replace(
        base, num_layers=cfg["num_hidden_layers"], d_model=d, num_heads=h,
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // h,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        sliding_window=cfg.get("sliding_window") or 0,
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        qkv_bias=bool(cfg.get("use_bias", False)), moe=moe,
        param_dtype=param_dtype or cfg["torch_dtype"],
        compute_dtype=cfg["torch_dtype"])


def check_layout(cfg: dict, pcfg) -> None:
    """The port's parameter tree has the benchmark's layout."""
    from repro_torch.models import api
    from repro_torch.models.common import tree_paths
    from portbench.weights import layout
    got = {p: tuple(s.shape) for p, s in tree_paths(api.specs(pcfg))}
    want = {p: tuple(s) for p, (s, _) in layout(cfg).items()}
    if got != want:
        raise SystemExit(f"the port's parameter layout differs from the "
                         f"benchmark's: port {got}, benchmark {want}")
