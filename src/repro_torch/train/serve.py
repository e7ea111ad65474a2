"""Batched serving: prefill and decode functions, greedy or sampled
generation (counterpart of ``repro.train.serve``).  ``generate`` is the
sequential reference the batched engine is held to, token for token.

Under ``jit=True`` (the default, as the reference's) the prefill and the
decode step are ``train.graphs.GraphedStage``s: on CUDA each is captured
as a CUDA graph per shape and cache, and replayed; on the CPU they run
eagerly.  The prefill of a windowed model or one with mamba mixers
(``Model.exact_prefill``) runs eagerly everywhere: each prompt length
would need its own graph, used once.  Their decode steps are captured:
a mamba layer's conv history and state are updated in place.  A vlm
or audio model's prefill takes its ``vision`` / ``frames`` as ``extras``
(graph inputs, like the tokens) and fills the cross cache that decode
reads.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from repro_torch.core.recipe import RECIPES, PrecisionRecipe
from repro_torch.models.model import Model
from repro_torch.train.graphs import GraphedStage, GraphPool

__all__ = ["make_prefill_fn", "make_decode_fn", "sample_tokens", "generate"]

# Serving fns, keyed per model instance (weak: dropping the model drops
# its fns and their graphs, so a fn holds its model by a weak reference)
# by (kind, recipe, jit).  Recipes are frozen dataclasses, so they hash;
# repeated ``generate`` calls reuse one fn and its captured graphs.  A
# model's fns share one graph pool (under the key "pool") and
# ``generate``'s KV caches (under "caches").
_FN_CACHE: "weakref.WeakKeyDictionary[Model, Dict[Any, Any]]" = \
    weakref.WeakKeyDictionary()
# Graphs a serving fn keeps, and KV caches ``generate`` keeps per model:
# each graph holds its cache, so the card's memory stays bounded however
# many prompt lengths come.
MAX_GRAPHS = 8
MAX_GENERATE_CACHES = 4


def _cached(model: Model, key, build):
    try:
        hash(key)
    except TypeError:
        return build()
    per_model = _FN_CACHE.setdefault(model, {})
    if key not in per_model:
        per_model[key] = build()
    return per_model[key]


def _serving_fn(model: Model, kind: str, recipe: PrecisionRecipe,
                jit: bool, pool: GraphPool):
    """``fn(params, tokens, cache[, extras])`` calling ``Model.prefill``
    (with ``extras``) or ``Model.decode_step`` of ``model`` (held weakly)
    under ``recipe``."""
    ref = weakref.ref(model)

    def step(params, tokens, cache, extras=None):
        if kind == "prefill":
            return ref().prefill(params, tokens, cache, recipe,
                                 extras=extras)
        return ref().decode_step(params, tokens, cache, recipe)
    if not jit or (kind == "prefill" and model.exact_prefill):
        return step
    stage = GraphedStage(lambda p, c, t, e: step(p, t, c, e), kind, pool,
                         max_graphs=MAX_GRAPHS)

    def fn(params, tokens, cache, extras=None):
        logits, cache = stage(params, cache, tokens, extras)
        return logits.clone(), cache
    fn.stage = stage
    return fn


def make_prefill_fn(model: Model, recipe: PrecisionRecipe, *, jit=True):
    """``fn(params, tokens, cache, extras=None) -> (last logits, cache)``,
    the cache updated in place and returned; ``extras`` holds a vlm's
    ``vision`` or an audio model's ``frames``.  Under ``jit`` on CUDA a
    graph is captured per (params, cache) by address and tokens and
    extras by shape (both copied into the graph's static buffers): a
    caller that reuses its cache replays; the fn keeps its ``MAX_GRAPHS``
    most recently used graphs.  A windowed or SSM model's prefill runs
    eagerly (``Model.exact_prefill``)."""
    return _cached(model, ("prefill", recipe, jit), lambda: _serving_fn(
        model, "prefill", recipe, jit, _cached(model, "pool", GraphPool)))


def make_decode_fn(model: Model, recipe: PrecisionRecipe, *, jit=True):
    """``fn(params, token (B, 1), cache) -> (logits, cache)``; graphs and
    the cache as in ``make_prefill_fn``."""
    return _cached(model, ("decode", recipe, jit), lambda: _serving_fn(
        model, "decode_step", recipe, jit, _cached(model, "pool", GraphPool)))


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """(B, V) logits -> (B, 1) tokens: the argmax (f32) at temperature 0,
    else a draw from ``softmax(logits / temperature)`` with ``generator``
    (on the logits' device; the reference's ``jax.random`` key)."""
    lg = logits.to(torch.float32)
    if temperature > 0:
        if generator is None:
            raise ValueError("sampling (temperature > 0) needs a "
                             "torch.Generator")
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(lg, dim=-1)[:, None]


def _generate_cache(model: Model, batch: int, max_len: int):
    """An empty KV cache of (batch, max_len) for ``generate`` under
    ``jit``: the same buffers for every call of that shape (its graphs
    are keyed by their addresses), the ``MAX_GENERATE_CACHES`` most
    recently used shapes kept."""
    caches = _cached(model, "caches", OrderedDict)
    key = (batch, max_len)
    if key not in caches:
        while len(caches) >= MAX_GENERATE_CACHES:
            caches.popitem(last=False)
        caches[key] = model.init_cache(batch, max_len)
    caches.move_to_end(key)
    cache = caches[key]
    model.reset_cache(cache)
    return cache


@torch.no_grad()
def generate(model: Model, params, prompts: torch.Tensor, *,
             max_new_tokens: int = 32,
             recipe: Optional[PrecisionRecipe] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             extras: Optional[Dict[str, torch.Tensor]] = None,
             jit: bool = True) -> torch.Tensor:
    """Greedy (or sampled, ``temperature`` > 0 with ``generator``)
    generation.  prompts (B, S) int -> (B, S + max_new_tokens), on the
    model's device; ``extras`` holds a vlm's ``vision`` (B, n_patches, D)
    or an audio model's ``frames`` (B, n_frames, D).  Tokens are chosen
    outside the graphs."""
    recipe = recipe or RECIPES["bf16"]
    prompts = prompts.to(model.device)
    if extras is not None:
        extras = {k: v.to(model.device) for k, v in extras.items()}
    b, s = prompts.shape
    if not jit:
        # Cast once up front, so the eager steps' casts are free.  A
        # graph casts inside (once per replay), so that its key, the
        # weights' addresses, stays the caller's from call to call.
        params = model.cast_params(params)
    cache = (_generate_cache(model, b, s + max_new_tokens) if jit
             else model.init_cache(b, s + max_new_tokens))
    prefill = make_prefill_fn(model, recipe, jit=jit)
    decode = make_decode_fn(model, recipe, jit=jit)
    logits, cache = prefill(params, prompts, cache, extras)
    toks = [prompts]
    for i in range(max_new_tokens):
        cur = sample_tokens(logits[:, -1], temperature, generator)
        toks.append(cur.to(prompts.dtype))
        if i < max_new_tokens - 1:
            logits, cache = decode(params, cur, cache)
    return torch.cat(toks, dim=1)
