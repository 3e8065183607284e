"""Mesh construction on ``torch.distributed.device_mesh.DeviceMesh``.

Port of ``repro/launch/mesh.py``. The meshes are built by FUNCTIONS, never
module-level constants, so importing this module touches no process group.

A mesh needs an initialised process group whose world size is the mesh's
device count (``torchrun``, or ``torch.distributed.init_process_group``
with an address, a rank and a world size): :func:`make_mesh` raises
otherwise, and never starts one itself, so a sharded step cannot fall back
to a one-device run by accident. The device type comes from
``device.resolve`` (the GPU unless the caller asks for the CPU).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import device as devmod


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> DeviceMesh:
    """A mesh of ``shape`` over the initialised process group, its dims
    named ``axes``."""
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs an initialised process group "
                           f"of world size {n}; none is initialised")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs world size {n}, "
                           f"the process group has {dist.get_world_size()}")
    dev = devmod.resolve(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """16x16 = 256 devices per pod; ``multi_pod`` adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device=None, group=None) -> DeviceMesh:
    """Single-device mesh (axes sized 1): over the initialised process group
    of world size 1, or over ``group``, a group of this rank alone inside a
    larger world (``dist.new_group([rank])``)."""
    if group is None:
        return make_mesh((1, 1), ("data", "model"), device)
    if group.size() != 1:
        raise RuntimeError(f"a 1x1 mesh needs a group of one rank, this one has {group.size()}")
    dev = devmod.resolve(device)
    return DeviceMesh.from_group([group, group], dev.type, mesh=[[dist.get_rank()]],
                                 mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pod included when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
