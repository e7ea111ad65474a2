"""Declarative parameter specs and seeded init (counterpart of
``repro.nn.params``).  Parameters are plain nested dicts of tensors
mirroring the reference's pytree, so a tree carries across by key path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

__all__ = ["ParamSpec", "init_params", "map_specs"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter tensor: shape, logical axis names, initializer
    ('normal' fan-in scaled truncated normal unless ``scale``, 'embed'
    normal with std 1/sqrt(d), 'zeros', 'ones'), optional dtype."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"
    scale: Optional[float] = None
    dtype: Optional[Any] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def map_specs(fn, tree):
    """Apply ``fn`` to every ParamSpec leaf of a nested dict/list tree."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return [map_specs(fn, v) for v in tree]


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype
               ) -> torch.Tensor:
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=gen.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=gen.device)
    if spec.init in ("normal", "embed"):
        if spec.scale is not None:
            std = spec.scale
        elif spec.init == "embed":
            std = 1.0 / math.sqrt(spec.shape[-1])
        else:
            shape = spec.shape
            std = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2
                                  else shape[-1])
        x = torch.empty(spec.shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return (x * std).to(dt)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs, seed: int, dtype=torch.float32, device="cpu",
                on_device: bool = False):
    """Initialize a tree of tensors from a tree of ParamSpec, from one
    seeded CPU ``torch.Generator`` (so every device gets the same
    weights), then move them to ``device``.  ``on_device`` draws them
    on ``device`` from a generator there instead: other numbers than the
    CPU's, and far faster for a model of billions of parameters."""
    gen = torch.Generator(device=device if on_device else "cpu")
    gen.manual_seed(seed)
    return map_specs(lambda s: _init_leaf(s, gen, dtype).to(device), specs)
