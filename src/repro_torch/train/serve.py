"""Sequential greedy generation (counterpart of
``repro.train.serve.generate``): the reference the batched engine is held
to, token for token."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.recipe import RECIPES, PrecisionRecipe
from repro_torch.models.model import Model

__all__ = ["generate"]


@torch.no_grad()
def generate(model: Model, params, prompts: torch.Tensor, *,
             max_new_tokens: int = 32,
             recipe: Optional[PrecisionRecipe] = None) -> torch.Tensor:
    """Greedy generation.  prompts (B, S) int -> (B, S + max_new_tokens),
    on the model's device."""
    recipe = recipe or RECIPES["bf16"]
    prompts = prompts.to(model.device)
    b, s = prompts.shape
    params = model.cast_params(params)
    cache = model.init_cache(b, s + max_new_tokens)
    logits, cache = model.prefill(params, prompts, cache, recipe)
    toks = [prompts]
    for i in range(max_new_tokens):
        cur = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)[:, None]
        toks.append(cur.to(prompts.dtype))
        if i < max_new_tokens - 1:
            logits, cache = model.decode_step(params, cur, cache, recipe)
    return torch.cat(toks, dim=1)
