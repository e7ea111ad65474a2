"""Global-norm gradient clipping (counterpart of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in f32, leaf by leaf in
    tree order as the reference sums."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, *, norm=None):
    """(tree scaled by min(1, max_norm / max(norm, 1e-12)), norm).  The
    leaves are scaled in place and the same tree is returned: no second
    copy of the gradients is alive at once.  An f32 leaf's ``mul_`` is the
    reference's ``(g.astype(f32) * scale).astype(g.dtype)`` bit for bit;
    a leaf of a narrower dtype is scaled in f32 and rounded back, as
    there.  ``norm`` (default ``global_norm(tree)``) is the norm to clip
    by: a data-parallel step whose leaves are shards passes the norm of
    the whole gradient."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    done = set()
    for g in tree_leaves(tree):
        # autograd may hand two leaves one gradient tensor: scale it once
        key = (g.data_ptr(), g.shape, g.dtype)
        if key in done:
            continue
        done.add(key)
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return tree, norm
