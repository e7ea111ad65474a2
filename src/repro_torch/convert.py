"""Carry a training state across between the JAX reference and the port.

``params_from_jax(tree, cfg)`` takes the reference's tree as nested dicts
/ lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's tree of CPU tensors with the same key paths.  Both stack
layouts load: ``stack.layers`` (unrolled) and ``stack.groups``
(scan-stacked, leading layers axis).  Weights come across dense; the port
packs them itself with ``quantize_weights_for_serving``.
``opt_state_from_jax`` does the same for the optimizer state (the
reference's ``AdamWState`` / ``AdafactorState`` NamedTuple).  Checkpoint
files need neither: the port's ``checkpoint`` reads and writes the
reference's layout and keys directly, both ways.
Only numpy is read here, never jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState

__all__ = ["params_from_jax", "opt_state_from_jax"]


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


def _tensors(tree, specs):
    """``tree``'s leaves as tensors, its dicts in the key order of the
    parameter ``specs`` (the optimizers walk state and parameters leaf by
    leaf in one order; the reference's trees come with sorted keys)."""
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"keys {sorted(tree)} != {sorted(specs)}")
        return {k: _tensors(tree[k], specs[k]) for k in specs}
    if isinstance(specs, list):
        return [_tensors(t, s) for t, s in zip(tree, specs)]
    return _tensor(tree)


def opt_state_from_jax(state, cfg: ModelConfig):
    """The port's optimizer state (CPU tensors) from the reference's
    (numpy leaves): AdamW's moments checked against the parameter specs
    as ``params_from_jax`` checks the weights; Adafactor's factors in
    the parameters' key order, their shapes as they are."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    count = int(np.asarray(fields["count"]))
    if set(fields) == {"count", "mu", "nu"}:
        return AdamWState(count, params_from_jax(fields["mu"], cfg),
                          params_from_jax(fields["nu"], cfg))
    if set(fields) == {"count", "vr", "vc"}:
        layout = "groups" if "groups" in fields["vr"]["stack"] else "layers"
        specs = build_model(dataclasses.replace(
            cfg, scan_layers=layout == "groups"), "cpu").param_specs()
        return AdafactorState(count, _tensors(fields["vr"], specs),
                              _tensors(fields["vc"], specs))
    raise ValueError(f"unknown optimizer state fields {sorted(fields)}")

