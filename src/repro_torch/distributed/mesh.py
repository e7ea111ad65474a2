"""Meshes (counterpart of ``repro.distributed.mesh``).

``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the current world; ``torch.distributed`` must already be
initialised (``torchrun``, or ``init_process_group`` with a store) with
a world of at least ``prod(shape)`` ranks.  ``AbstractMesh`` is the
device-free description (axis names and sizes), the counterpart of
``jax.sharding.AbstractMesh``: sharding rules for a 16 x 16 mesh are
computed on it without 256 processes.
"""
from __future__ import annotations

import collections
import math
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["AbstractMesh", "make_mesh", "mesh_axis_sizes",
           "init_distributed"]

_AXIS_TYPES = ("auto", "explicit", "manual")


class AbstractMesh:
    """Axis sizes and names, no devices (``AbstractMesh((16, 16),
    ("data", "model"))``, as JAX's)."""

    def __init__(self, axis_sizes: Tuple[int, ...],
                 axis_names: Tuple[str, ...]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for "
                             f"{len(axis_names)} axis names")
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.axis_sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.axis_sizes}, {self.axis_names})"


def mesh_axis_sizes(mesh) -> "collections.OrderedDict[str, int]":
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return collections.OrderedDict(zip(mesh.mesh_dim_names,
                                       tuple(mesh.mesh.shape)))


def _resolve_axis_types(axis_types: Sequence[Union[str, object]],
                        n_axes: int) -> Tuple[str, ...]:
    """The reference's validation of ``axis_types``, error for error: one
    entry an axis, each 'auto' | 'explicit' | 'manual' (any case)."""
    if len(axis_types) != n_axes:
        raise ValueError(f"axis_types has {len(axis_types)} entries for "
                         f"{n_axes} mesh axes")
    out = []
    for t in axis_types:
        name = str(t).lower()
        if name not in _AXIS_TYPES:
            raise ValueError(f"unknown axis type {t!r}; "
                             f"have {sorted(_AXIS_TYPES)}")
        out.append(name)
    return tuple(out)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[Sequence[int]] = None,
              axis_types: Optional[Sequence[Union[str, object]]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the world (or of ``devices``, a list of
    global ranks): of device type ``cuda`` on an NCCL world, else
    ``cpu``.

    ``axis_types`` is validated as the reference validates it and then
    has no effect: a ``DeviceMesh`` has no GSPMD axis modes (every port
    collective is explicit, so every axis acts as the reference's
    'auto' data axes under a manual region would)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices if devices is not None else range(world))[:n]
    if len(ranks) < n:
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    if axis_types is not None:
        _resolve_axis_types(axis_types, len(axes))
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh{tuple(shape)}: torch.distributed is not "
            f"initialised; launch {n} rank(s) with torchrun (or call "
            "init_process_group) first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axes))


def init_distributed(device: str = "cuda") -> bool:
    """Join the world ``torchrun`` describes (``WORLD_SIZE`` and the
    rendezvous in the environment), or make a world of this process
    alone; NCCL for ``device`` cuda (each rank on card ``LOCAL_RANK``),
    ``gloo`` otherwise.  Returns True when it initialised the group
    (False: one was already up)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if str(device).startswith("cuda") else "gloo"
    if "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True
