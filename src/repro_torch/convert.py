"""Carry a parameter tree across from the JAX reference.

``params_from_jax(tree, cfg)`` takes the reference's tree as nested dicts
/ lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's tree of CPU tensors with the same key paths.  Both stack
layouts load: ``stack.layers`` (unrolled) and ``stack.groups``
(scan-stacked, leading layers axis).  Weights come across dense; the port
packs them itself with ``quantize_weights_for_serving``.  Only numpy is
read here, never jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model

__all__ = ["params_from_jax"]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: carry the raw bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _convert(tree, specs, path):
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"{path or '<root>'}: keys "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)} "
                             f"!= {sorted(specs)}")
        return {k: _convert(tree[k], specs[k], f"{path}/{k}") for k in specs}
    if isinstance(specs, list):
        if len(tree) != len(specs):
            raise ValueError(f"{path}: {len(tree)} layers != {len(specs)}")
        return [_convert(t, s, f"{path}/{i}")
                for i, (t, s) in enumerate(zip(tree, specs))]
    t = _tensor(tree)
    if tuple(t.shape) != tuple(specs.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)} != {specs.shape}")
    return t


def params_from_jax(tree, cfg: ModelConfig):
    """The port's parameter tree (CPU tensors) from the reference's numpy
    tree, checked key by key and shape by shape against the port's specs
    for ``cfg`` in whichever stack layout ``tree`` uses."""
    layout = "groups" if "groups" in tree["stack"] else "layers"
    cfg = dataclasses.replace(cfg, scan_layers=layout == "groups")
    specs = build_model(cfg, "cpu").param_specs()
    return _convert(tree, specs, "")
