"""Adafactor (Shazeer & Stern 2018): factored second moments, no
momentum (counterpart of ``repro.optim.adafactor``).

Second moments are factored over the last two dims of a >= 2-D
parameter (row and column means of ``g^2``), kept whole for vectors: a
parameter costs O(rows + cols) of state instead of AdamW's two f32
copies.  As the port's AdamW, ``update`` writes the parameters and the
factors in place and returns them; ``beta2 = 1 - count^-decay`` is
computed in f32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import Optimizer
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["adafactor", "AdafactorState"]


class AdafactorState(NamedTuple):
    count: int
    vr: Any     # row factors (the whole second moment of a vector)
    vc: Any     # column factors (an empty placeholder for a vector)


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr_of(p):
            return zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, p)

        def vc_of(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2
                         else (0,), p)
        return AdafactorState(0, tree_map(vr_of, params),
                              tree_map(vc_of, params))

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state.count + 1
        beta2 = 1.0 - torch.tensor(float(count), dtype=torch.float32) ** (
            -decay)
        for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.vr),
                                tree_leaves(state.vc), tree_leaves(params)):
            b2 = beta2.to(p.device)
            g = g.to(torch.float32)
            g2 = g * g + eps
            if p.dim() >= 2:
                vr.copy_(b2 * vr + (1 - b2) * g2.mean(dim=-1))
                vc.copy_(b2 * vc + (1 - b2) * g2.mean(dim=-2))
                rfac = torch.rsqrt(vr / torch.clamp(
                    vr.mean(dim=-1, keepdim=True), min=eps))
                u = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                vr.copy_(b2 * vr + (1 - b2) * g2)
                u = g * torch.rsqrt(vr)
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.to(torch.float32)
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * pf
            p.copy_(pf - lr * u)
        return params, AdafactorState(count, state.vr, state.vc)

    return Optimizer(init=init, update=update, name="adafactor")
