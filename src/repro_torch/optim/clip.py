"""Global-norm gradient clipping (counterpart of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in f32, leaf by leaf in
    tree order as the reference sums."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / max(norm, 1e-12)), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm
