"""Declarative parameter specs and seeded init (counterpart of
``repro.nn.params``).  Parameters are plain nested dicts of tensors
mirroring the reference's pytree, so a tree carries across by key path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

__all__ = ["ParamSpec", "init_params", "map_specs", "spec_leaves",
           "param_count"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter tensor: shape, logical axis names, initializer
    ('normal' fan-in scaled truncated normal unless ``scale``, 'embed'
    normal with std 1/sqrt(d), 'zeros', 'ones', and Mamba2's 'a_log' and
    'dt_bias'), optional dtype."""

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


def spec_leaves(tree) -> list:
    """The ParamSpec leaves of a tree, in tree order."""
    if isinstance(tree, ParamSpec):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [s for v in items for s in spec_leaves(v)]


def param_count(specs) -> int:
    """Total parameter count of a ParamSpec tree."""
    return sum(math.prod(s.shape) for s in spec_leaves(specs))


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype
               ) -> torch.Tensor:
    dt = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=gen.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=gen.device)
    if spec.init == "a_log":
        # Mamba2's A uniform in [1, 16), stored as its log
        u = torch.empty(spec.shape, dtype=torch.float32, device=gen.device)
        u.uniform_(1.0, 16.0, generator=gen)
        return torch.log(u).to(dt)
    if spec.init == "dt_bias":
        # softplus(dt_bias) log-uniform in [1e-3, 1e-1]: the inverse
        # softplus of the drawn step, as the reference computes it
        u = torch.empty(spec.shape, dtype=torch.float32, device=gen.device)
        u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        dt_val = torch.clamp(torch.exp(u), min=1e-4)
        return (dt_val + torch.log(-torch.expm1(-dt_val))).to(dt)
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
