"""Adafactor (Shazeer & Stern 2018): factored second moments, no
momentum (counterpart of ``repro.optim.adafactor``).

Second moments are factored over the last two dims of a >= 2-D
parameter (row and column means of ``g^2``), kept whole for vectors: a
parameter costs O(rows + cols) of state instead of AdamW's two f32
copies.  As the port's AdamW, ``update`` writes the parameters and the
factors in place and returns them; ``beta2 = 1 - count^-decay`` is
computed in f32.

Under fsdp a parameter leaf is a block of a dim sharded over a data
group; ``update(..., shards=)`` then takes, for each leaf, that dim and
group (``train_step.DataParallel.opt_shards``; None: a whole leaf), or
a tuple of such splits (a data block of one dim and a tensor-parallel
block of another).  A mean over a split dim (a factor's row or column
mean, the row factors' mean, the update's RMS) sums the block,
all-reduces the sums over that split's group and divides by the global
count, so each rank's factors are the blocks (or, reduced over the split
dim, the whole) of the one-device factors, as the reference's
``opt_state_shardings`` lays them out.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed import comms
from repro_torch.optim.adamw import Optimizer
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["adafactor", "AdafactorState"]


class AdafactorState(NamedTuple):
    count: int
    vr: Any     # row factors (the whole second moment of a vector)
    vc: Any     # column factors (an empty placeholder for a vector)


def _mean(x: torch.Tensor, dims, shard, keepdim: bool = False
          ) -> torch.Tensor:
    """``x.mean(dims)`` (None: every dim) of a tensor whose dim
    ``shard.dim`` is a block over ``shard.group`` (``shard`` None: x is
    whole; a tuple: one block a split): the partial sums all-reduced over
    each split group of a reduced dim, over the global count."""
    alldims = tuple(range(x.dim())) if dims is None else dims
    shards = shard if isinstance(shard, tuple) else (shard,)
    shards = [sh for sh in shards if sh is not None and sh.dim in alldims]
    if not shards:
        return x.mean() if dims is None else x.mean(dim=dims,
                                                    keepdim=keepdim)
    total = x.sum() if dims is None else x.sum(dim=dims, keepdim=keepdim)
    n = 1
    for d in alldims:
        n *= x.shape[d]
    for sh in shards:
        total = comms.all_reduce(total.contiguous(), "sum", sh.group,
                                 tag="opt")
        n *= sh.size
    return total / n


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
    def update(grads, state, params, lr, shards=None):
        count = state.count + 1
        beta2 = 1.0 - torch.tensor(float(count), dtype=torch.float32) ** (
            -decay)
        shards = (tree_leaves(shards) if shards is not None
                  else [None] * len(tree_leaves(params)))
        for g, vr, vc, p, sh in zip(tree_leaves(grads),
                                    tree_leaves(state.vr),
                                    tree_leaves(state.vc),
                                    tree_leaves(params), shards):
            b2 = beta2.to(p.device)
            g = g.to(torch.float32)
            g2 = g * g + eps
            nd = p.dim()
            if nd >= 2:
                vr.copy_(b2 * vr + (1 - b2) * _mean(g2, (nd - 1,), sh))
                vc.copy_(b2 * vc + (1 - b2) * _mean(g2, (nd - 2,), sh))
                # vr's last dim is the parameter's dim nd - 2
                rfac = torch.rsqrt(vr / torch.clamp(
                    _mean(vr, (nd - 2,), sh, keepdim=True), min=eps))
                u = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                vr.copy_(b2 * vr + (1 - b2) * g2)
                u = g * torch.rsqrt(vr)
            # update clipping by RMS
            rms = torch.sqrt(_mean(u * u, None, sh) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.to(torch.float32)
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * pf
            p.copy_(pf - lr * u)
        return params, AdafactorState(count, state.vr, state.vc)

    return Optimizer(init=init, update=update, name="adafactor")
