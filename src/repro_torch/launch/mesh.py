"""Mesh shapes of the port, and the ring a TAC step runs on.

Counterpart of ``repro/launch/mesh.py``. The reference builds JAX
device meshes; the port's manual (TAC) steps run on a ring of peers, one
process each (``core/channels.Ring``). A :class:`Mesh` here is the
shape and axis names only, and :func:`make_ring` lays the peers of a
``torch.distributed`` group out on it the way the reference's TAC step
flattens its mesh (``repro/launch/steps.py``, ``make_train_step_tac``):
every axis flattened into one ring, pod-major, with the ``pod`` axis
(when its size is above 1) as the ring's pod axis, so each pod holds the
``data x model`` peers of its slice. The world size must equal the
mesh's size.

``make_production_mesh`` is the reference's 16x16 pod, or 2x16x16 with a
pod axis; the dry run (``launch/dryrun``) lays a fake process group of
that size out on it. The serving fabric keeps ``Ring(pods, pod_axis)``
(``launch/serve --pods``). ``make_abstract_mesh`` and the GSPMD
family's device meshes wait for ``launch/sharding``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from repro_torch.core.channels import Ring


@dataclass(frozen=True)
class Mesh:
    """A mesh's dims and axis names (``pod`` first when present)."""

    dims: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} and axes "
                             f"{self.axis_names} differ in length")
        if any(d < 1 for d in self.dims):
            raise ValueError(f"mesh dims must be >= 1, got {self.dims}")
        if "pod" in self.axis_names and self.axis_names[0] != "pod":
            raise ValueError("the pod axis must be the mesh's first axis "
                             f"(pod-major peers), got {self.axis_names}")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 peers per pod; 2 pods = 512 peers multi-pod."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """Any mesh, for tests and tools."""
    return Mesh(tuple(int(d) for d in shape), tuple(axes))


def parse_mesh(spec: str) -> Mesh:
    """The train CLI's ``--mesh``: ``"AxB"`` is ``("data", "model")``
    (``"A"`` alone ``("data",)``), ``"AxBxC"`` is ``("pod", "data",
    "model")``, the reference's rule."""
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes 'A', 'AxB' or 'AxBxC' with integer "
                         f"dims, got {spec!r}") from None
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"--mesh takes 1 to 3 dims, got {spec!r}")
    axes = ("data", "model")[:len(dims)] if len(dims) <= 2 \
        else ("pod", "data", "model")
    return make_mesh(dims, axes)


def data_axes(mesh: Mesh) -> tuple:
    """The DP axes of a mesh (everything that is not 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def make_ring(mesh: Mesh, group: Optional[dist.ProcessGroup] = None, *,
              channels: int = 1) -> Ring:
    """The TAC step's ring over ``mesh``: the peers of ``group`` (None:
    the default group), every mesh axis flattened pod-major, with
    ``pods`` = the pod axis's size and ``pod_axis="pod"`` when that size
    is above 1 (the reference's TAC step treats a pod axis of size 1 as
    none). The group's size must equal the mesh's."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world != mesh.size:
        raise ValueError(
            f"a mesh of {mesh.dims} over {mesh.axis_names} needs "
            f"{mesh.size} peers; the process group has {world}")
    if axis_size(mesh, "pod") == 1:
        return Ring(group, channels=channels)
    return Ring(group, channels=channels, pods=axis_size(mesh, "pod"),
                pod_axis="pod")
