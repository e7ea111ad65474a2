"""LR schedule of the paper (App. B; counterpart of
``repro.optim.schedule``): linear warmup over 0.15% of the steps, then
cosine decay to 10% of the peak."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(peak_lr: float, total_steps: int,
                  warmup_frac: float = 0.0015, min_frac: float = 0.1):
    """``lr(step)`` -> f32 0-dim CPU tensor, computed in f32 as the
    reference traces it (divisions by tensors: IEEE, not a reciprocal
    multiply)."""
    warmup = max(int(total_steps * warmup_frac), 1)
    f32 = torch.float32
    w = torch.tensor(warmup, dtype=f32)
    span = torch.tensor(max(total_steps - warmup, 1), dtype=f32)

    def lr(step) -> torch.Tensor:
        s = torch.tensor(step, dtype=f32)
        warm = peak_lr * (s + 1) / w
        t = torch.clamp((s - warmup) / span, 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, peak_lr * cos)

    return lr
