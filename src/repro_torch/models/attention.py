"""Self-attention with KV caches, and cross-attention over encoder or
vision states (counterpart of ``repro.models.attention``).

The Q/K/V/O projections are the recipe's attention-class linears.  The
attention core without a cache takes the flash kernel under
``attention_impl="pallas"`` when there is no window and the sequence is a
multiple of 128 (``kernels.ops.flash_attention``, the reference's route);
otherwise, and over a cache, it is plain PyTorch, ported from the
reference's chunked online softmax (the reference computes it in jnp
too).  Over a cache it runs one batch row at a time, so that a row's
result does not depend on the batch's size (serving's engine against
sequential generation).  It is not SDPA: unwritten cache slots carry position -1 and are
masked by position, and the chunked f32 accumulation is the reference's
numerics.

Cross-attention (``cross_attention``) is the reference's: non-causal
chunked attention of the text's queries over K/V projected from
``kv_states`` (every query at position 0, key j at position j), never the
flash kernel (the reference never sends it there).  With a cache (the
layer's ``cross`` entry, exactly as long as the states) a prefill writes
the projected K/V into it in place and a decode step reads them; over a
cache it runs a row at a time, as the cached self-attention does.

A cache is allocated in whole chunks of ``attention_chunk`` positions
(``attn_cache_spec``; a ring keeps its window's size), the extra slots
unwritten (position -1), so over a cache the keys run in chunks of
``attention_chunk`` whatever ``max_len`` is: an engine's ``max_len``
cache and ``generate``'s prompt-plus-new-tokens cache give the same bits.
A chunk holding no valid key for a row leaves the row's running max, sum
and accumulator bit for bit as they were (its correction factor is
exactly 1 and its probabilities exactly 0).  The reference allocates
``max_len`` and takes ``min(chunk, cache length)``, whose last product's
reduction length, and so its order on the card, follows the cache's
length.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch import constant
from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import model_grad_sum
from repro_torch.core.quantize import model_split
from repro_torch.core.recipe import MatmulRecipe
from repro_torch.kernels.ops import flash_attention
from repro_torch.nn.layers import linear, rope
from repro_torch.nn.params import ParamSpec

__all__ = ["attn_param_specs", "cross_attn_param_specs", "attention",
           "cross_attention", "chunked_attention", "attn_cache_spec",
           "init_attn_cache", "NEG_INF"]

NEG_INF = -1e30


def attn_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, nq * hd), ("embed", "heads")),
        "wk": ParamSpec((d, nkv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, nkv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((nq * hd, d), ("heads", "embed"),
                        scale=1.0 / math.sqrt(nq * hd
                                              * max(cfg.n_layers, 1))),
    }


def cross_attn_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Q from the text, K / V from the cross states, all of width
    d_model; O back to d_model."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, nq * hd), ("embed", "heads")),
        "wk": ParamSpec((d, nkv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, nkv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((nq * hd, d), ("heads", "embed"),
                        scale=1.0 / math.sqrt(nq * hd
                                              * max(cfg.n_layers, 1))),
    }


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(..., Sq, Sk) additive mask from absolute positions; ``k_pos`` < 0
    marks an unwritten cache slot."""
    valid = (k_pos >= 0)[..., None, :]
    if causal:
        valid = valid & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window:
        valid = valid & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, kvh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kvh, n_rep, d).reshape(
        b, s, kvh * n_rep, d)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks.  q (B, Sq, H, D), k/v
    (B, Sk, KVH, D); positions (S,) or (B, S), -1 = invalid key.  Scores
    and the running sums are f32; probabilities are cast to v's dtype
    before the second product, as in the reference."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q_pos.dim() == 2:
        q_pos = q_pos[:, None]            # (B, 1, Sq)
    if k_pos.dim() == 2:
        k_pos = k_pos[:, None]            # (B, 1, Sk)
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scale = constant(1.0 / math.sqrt(d), q.dtype, q.device)
    qf = (q * scale).transpose(1, 2).to(torch.float32)   # (B, H, Sq, D)
    kf = k.transpose(1, 2)
    vf = v.transpose(1, 2)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    chunk = min(chunk, sk)
    for c0 in range(0, sk, chunk):
        kc = kf[:, :, c0:c0 + chunk].to(torch.float32)
        vc = vf[:, :, c0:c0 + chunk]
        s = torch.matmul(qf, kc.transpose(-1, -2))
        s = s + _mask_bias(q_pos, k_pos[..., c0:c0 + chunk], causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Fully masked rows: exp(-inf - (-inf)) must be 0, not 1.
        safe_m = torch.where(m_new <= NEG_INF / 2,
                             torch.zeros_like(m_new), m_new)
        corr = torch.exp(m - safe_m) * (m > NEG_INF / 2)
        p = torch.exp(s - safe_m[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(v.dtype).to(torch.float32), vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)               # (B, Sq, H, D)


def attention(params, cfg: ModelConfig, x: torch.Tensor,
              recipe: MatmulRecipe, *, positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_len: Optional[torch.Tensor] = None,
              causal: bool = True) -> torch.Tensor:
    """Self-attention sublayer.  With ``cache`` the new K/V are written
    into it in place (at ``cache_len``, a scalar or per-slot (B,) tensor)
    and attention reads the whole cache.

    Under tensor parallelism the weights are the rank's blocks (the
    Megatron layout; ``_local_heads``): ``wq`` / ``wk`` / ``wv``
    column-parallel over the heads, ``wo`` row-parallel, and the core runs
    on the rank's heads.  KV heads that the rules keep whole (their count
    does not divide the model axis) are projected whole on every rank;
    each rank reads the KV heads its query heads use, and the cotangent of
    K / V is summed over the model group before their linears'
    backward."""
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv, q_tp, kv_tp, kv_pick = _local_heads(params, cfg)
    q = linear(x, params["wq"], recipe, cfg, tp=q_tp).reshape(b, sq, nq, hd)
    k = linear(x, params["wk"], recipe, cfg, tp=kv_tp)
    v = linear(x, params["wv"], recipe, cfg, tp=kv_tp)
    if kv_pick is not None:
        k, v = model_grad_sum(k), model_grad_sum(v)
    k = k.reshape(b, sq, -1, hd)
    v = v.reshape(b, sq, -1, hd)
    if kv_pick is not None:
        k, v = k[:, :, kv_pick], v[:, :, kv_pick]
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window
    if cache is None:
        if (cfg.attention_impl == "pallas" and not window
                and sq % 128 == 0):
            out = flash_attention(q, k, v, causal=causal,
                                  chunk=cfg.attention_chunk)
        else:
            out = chunked_attention(q, k, v, positions, positions,
                                    causal=causal, window=window,
                                    chunk=cfg.attention_chunk)
    else:
        k_all, v_all, k_pos = _update_cache(cache, k, v, cache_len, window,
                                            cfg.kv_cache_format)
        out = _by_row(q, k_all, v_all, positions, k_pos, causal=causal,
                      window=window, chunk=cfg.attention_chunk)
    out = out.reshape(b, sq, nq * hd)
    return linear(out, params["wo"], recipe, cfg, tp="row" if q_tp else None)


def _local_heads(params, cfg: ModelConfig):
    """``(query heads, KV heads the core reads, wq's tp, wk / wv's tp,
    the KV heads' slice of whole K / V or None)`` of the weights this
    rank holds: the config's counts on one process; under a model split
    the rank's query heads (``wq`` a block, column-parallel) and its KV
    heads (``wk`` / ``wv`` blocks), or, KV kept whole, the slice of KV
    heads its query heads ``index * nq ...`` use."""
    hd = cfg.resolved_head_dim
    nq = params["wq"].shape[-1] // hd
    nkv = params["wk"].shape[-1] // hd
    if nq == cfg.n_heads:
        if nkv != cfg.n_kv_heads:
            raise ValueError("KV heads split over the model axis under "
                             "whole query heads")
        return nq, nkv, None, None, None
    split = model_split()
    if split is None or split.size * nq != cfg.n_heads:
        raise ValueError(f"wq holds {nq} of {cfg.n_heads} heads outside a "
                         "model split of that size")
    if nkv != cfg.n_kv_heads:
        return nq, nkv, "col", "col", None
    rep = cfg.n_heads // cfg.n_kv_heads        # query heads a KV head
    first = split.index * nq // rep
    n = max(1, nq // rep)
    return nq, n, "col", None, slice(first, first + n)


def _by_row(q, k, v, q_pos, k_pos, **kw) -> torch.Tensor:
    """``chunked_attention`` one batch row at a time.  cuBLAS picks its
    batched-GEMM algorithm by the batch count, so on the card a row of
    one batched call can differ in its last bits from the same row alone;
    per row, a slot of the batched engine computes what sequential
    generation computes, bit for bit."""
    def row(t, i):
        return t[i:i + 1] if t.dim() == 2 else t
    return torch.cat([chunked_attention(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], row(q_pos, i), row(k_pos, i),
        **kw) for i in range(q.shape[0])])


def cross_attention(params, cfg: ModelConfig, x: torch.Tensor,
                    recipe: MatmulRecipe, *,
                    kv_states: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Cross-attention sublayer over ``kv_states`` (B, Skv, Dkv), non-
    causal.  Training (no cache) and prefill (a cache given with the
    states) project K / V from the states; a prefill also writes them
    into ``cache`` ({"k", "v"}, (B, Skv, KVH, D)) in place.  A decode step
    (a cache and no states) reads K / V from the cache."""
    b, sq, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(x, params["wq"], recipe, cfg).reshape(b, sq, cfg.n_heads, hd)
    if kv_states is not None:
        skv = kv_states.shape[1]
        k = linear(kv_states, params["wk"], recipe, cfg).reshape(
            b, skv, cfg.n_kv_heads, hd)
        v = linear(kv_states, params["wv"], recipe, cfg).reshape(
            b, skv, cfg.n_kv_heads, hd)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    elif cache is not None:
        k, v = cache["k"], cache["v"]
    else:
        raise ValueError("cross_attention needs kv_states or a cache")
    skv = k.shape[1]
    k_pos = torch.arange(skv, dtype=torch.int32, device=x.device)
    q_pos = torch.zeros((sq,), dtype=torch.int32, device=x.device)
    kw = dict(causal=False, window=0, chunk=cfg.attention_chunk)
    out = (chunked_attention(q, k, v, q_pos, k_pos, **kw) if cache is None
           else _by_row(q, k, v, q_pos, k_pos, **kw))
    out = out.reshape(b, sq, cfg.n_heads * hd)
    return linear(out, params["wo"], recipe, cfg)


def attn_cache_spec(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    per_slot: bool = False) -> Dict[str, tuple]:
    """Cache layout of ONE attention layer, ``{name: (shape, dtype)}``:
    K/V (B, size, KVH, D) in ``dtype``, or uint8 codes plus (B, size, KVH)
    f32 scales under ``cfg.kv_cache_format``; ``pos`` (size,) or per-slot
    (B, size).  ``size`` is ``max_len`` rounded up to whole chunks of
    ``cfg.attention_chunk`` (module docstring), or under a sliding window
    at most the window (a ring)."""
    chunk = cfg.attention_chunk
    size = -(-max_len // chunk) * chunk
    if cfg.sliding_window:
        size = min(size, cfg.sliding_window)
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    spec = {"pos": ((batch, size) if per_slot else (size,), torch.int32)}
    if cfg.kv_cache_format:
        for n in ("k", "v"):
            spec[n] = (shape, torch.uint8)
            spec[f"{n}_scale"] = (shape[:3], torch.float32)
    else:
        for n in ("k", "v"):
            spec[n] = (shape, dtype)
    return spec


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype, device, per_slot: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Zeroed cache of ONE attention layer; ``pos`` -1 = unwritten."""
    cache = {n: torch.zeros(shape, dtype=dt, device=device)
             for n, (shape, dt) in attn_cache_spec(
                 cfg, batch, max_len, dtype, per_slot).items()}
    cache["pos"].fill_(-1)
    return cache


def _update_cache(cache, k, v, cache_len, window, kv_format=None):
    """Write new K/V at [cache_len, cache_len + sq) (mod the ring size for
    windowed caches), in place, and return (k_all, v_all, pos) for the
    read.  A per-slot (B,) ``cache_len`` writes each row at its own
    offset.  A write past the end of the cache lands on the row's last
    slot (the reference drops it).  Only a dead slot makes one: the
    engine refuses to decode a live slot whose cache is full, and the
    dead slot's next insert overwrites the whole row."""
    sq = k.shape[1]
    size = cache["k"].shape[1]
    start = cache_len.to(torch.int32)
    ar = torch.arange(sq, dtype=torch.int32, device=k.device)
    if start.dim():
        new_pos = start[:, None] + ar[None]
        idx = new_pos % size if window else torch.clamp(new_pos, max=size - 1)
        bidx = torch.arange(k.shape[0], device=k.device)[:, None]

        def put(dst, src):
            dst[bidx, idx.long()] = src.to(dst.dtype)
    else:
        new_pos = start + ar
        idx = new_pos % size if window else torch.clamp(new_pos, max=size - 1)

        def put(dst, src):
            dst[:, idx.long()] = src.to(dst.dtype)

    if kv_format is not None and "k_scale" in cache:
        from repro_torch.core.packed import kv_dequantize, kv_quantize
        for name, t in (("k", k), ("v", v)):
            codes, scale = kv_quantize(t, kv_format)
            put(cache[name], codes)
            put(cache[f"{name}_scale"], scale)
        k_all = kv_dequantize(cache["k"], cache["k_scale"], kv_format,
                              k.dtype)
        v_all = kv_dequantize(cache["v"], cache["v_scale"], kv_format,
                              v.dtype)
    else:
        put(cache["k"], k)
        put(cache["v"], v)
        k_all, v_all = cache["k"], cache["v"]
    if cache["pos"].dim() == 2:
        put(cache["pos"], new_pos)
    else:
        cache["pos"][idx.long()] = new_pos
    return k_all, v_all, cache["pos"]
