"""Device resolution for every entry point of the port.

Counterpart of ``repro/compat.py``, which shims JAX version drift. The
port's one environment question is where tensors live: on the card
unless the caller asks for the CPU. A missing card is an error, never a
quiet switch to the CPU, so a run that was meant to measure the card
cannot silently measure the host instead. The reference's mesh shims
(``make_mesh``, ``abstract_mesh``, ``shard_map``, ``set_mesh``,
``AxisType``) and its Pallas ones (``tpu_compiler_params``,
``pallas_available``) paper over JAX releases and have no counterpart:
the port's meshes are ``launch/mesh``'s ``DeviceMesh``es and its kernels
are CUDA built by ``kernels/build``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for (or
    defaulted to) and is not available; ``"cpu"`` is honoured only when
    the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the card unless "
                "the caller passes device='cpu' (or --device cpu)")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: expected cuda or cpu")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``/``"float32"``) -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
