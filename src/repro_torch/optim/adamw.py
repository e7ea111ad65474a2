"""AdamW with f32 master weights and f32 moments (counterpart of
``repro.optim.adamw``; paper App. B).

``opt.init(params) -> state``; ``opt.update(grads, state, params, lr) ->
(params, state)``.  Unlike the reference's pure update, this one writes
the new parameters and moments into the given tensors in place (no
second copy of the model and both moments on the card); it returns them
for the reference's call shape.  Weight decay is decoupled and applies
to matrices only (``p.dim() >= 2``); the bias corrections compute
``beta ** count`` in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["adamw", "Optimizer", "AdamWState"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]
    name: str = "opt"


class AdamWState(NamedTuple):
    count: int
    mu: Any
    nu: Any


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(device)


def adamw(beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state.count + 1
        cnt = torch.tensor(float(count), dtype=torch.float32)
        b1c = 1.0 - torch.tensor(beta1, dtype=torch.float32) ** cnt
        b2c = 1.0 - torch.tensor(beta2, dtype=torch.float32) ** cnt
        # the scalars live on each leaf's device: a CUDA op would take a
        # CPU divisor as a reciprocal multiply, not an IEEE division
        scalars = {}
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            if p.device not in scalars:
                scalars[p.device] = [_f32(x, p.device)
                                     for x in (b1c, b2c, lr)]
            d1, d2, lr_d = scalars[p.device]
            g = g.to(torch.float32)
            m.mul_(beta1).add_(g * (1 - beta1))
            v.mul_(beta2).add_(g * (1 - beta2) * g)
            step = (m / d1) / (torch.sqrt(v / d2) + eps)
            if p.dim() >= 2:   # decoupled weight decay on matrices only
                step = step + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr_d * step)
        return params, AdamWState(count, state.mu, state.nu)

    return Optimizer(init=init, update=update, name="adamw")
