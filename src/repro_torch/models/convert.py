"""Parameters and train state from numpy arrays (the port's own; no
``repro`` counterpart).

``from_numpy_params`` turns a nested dict of numpy arrays — for example
the reference's JAX param pytree after ``np.asarray`` on every leaf —
into the port's params with the same dotted paths.
``from_numpy_train_state`` does the same for a whole JAX ``TrainState``
(params, Adam moments and count, step, error feedback), tree or ZeRO-1
flat moments alike. bfloat16 arrives as
the ml_dtypes ``bfloat16`` numpy dtype, which ``torch.from_numpy``
rejects: it crosses as its 16-bit pattern (``int16``) and is
reinterpreted as ``torch.bfloat16``. The dtype is recognised by name, so
the port needs no ``ml_dtypes`` import.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.models.common import tree_map


def from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")          # an owned, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_numpy_params(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (the card unless "cpu")."""
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(np.asarray(a), dev), tree)


def from_numpy_train_state(state: Any, device: DeviceLike = None, *,
                           rank: int = 0):
    """The reference's ``TrainState`` after ``np.asarray`` on every leaf
    -> the port's ``launch.steps.TrainState`` on ``device``: params,
    Adam ``mu``/``nu``/``count``, ``step`` and the error feedback. The
    reference's ring-sharded leaves carry a leading ring dim and a port
    process holds its own row ``rank``: of the error feedback (one array
    keyed to the ring plan, or a tuple per bucket), and of the moments
    when they are ZeRO-1 flat shards, ``(n_shards, len)`` arrays instead
    of trees. Fields are read by name and layouts from the leaves, so
    the JAX types need not be importable."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import AdamState
    dev = resolve_device(device)
    row = lambda a: from_numpy(np.asarray(a)[rank], dev)
    moments = lambda m: from_numpy_params(m, dev) if isinstance(m, dict) \
        else row(m)
    ef = state.ef
    if ef is not None:
        ef = tuple(map(row, ef)) if isinstance(ef, (tuple, list)) \
            else row(ef)
    return TrainState(
        params=from_numpy_params(state.params, dev),
        opt=AdamState(mu=moments(state.opt.mu), nu=moments(state.opt.nu),
                      count=int(np.asarray(state.opt.count))),
        step=int(np.asarray(state.step)),
        ef=ef)
