"""Mamba2 mixer via SSD (state-space duality), in its chunked matmul form
(counterpart of ``repro.models.ssm``).

The five in-projections (split per segment: z / x / B / C / dt) and the
out-projection are FFN-class linears: they run the layer's ``ffn_linear``
cell of the plan (FP4 forward / FP8 wgrad under the paper's recipe),
through the GEMM kernels under ``linear_impl="pallas"``.  The SSD mixing
math, the depthwise causal conv and the gated norm stay in the compute
dtype, in plain PyTorch, as the reference keeps them in jnp outside any
Pallas kernel: the token-mixing part, protected as the paper protects
attention (§3.1).

Shapes: u (B, S, D); inside, x (B, S, H, P) with H = expand * D / headdim
heads, B / C (B, S, G, N) with G groups broadcast over the heads, dt
(B, S, H).

Three places where the port departs from the reference's formulas, each
giving the same forward values:

* The intra-chunk decay ``L`` is ``exp(where(tri, seg, -inf))``; the
  reference writes ``where(tri, exp(seg), 0)``.  Above the diagonal
  ``seg`` is a positive sum of ``dt * |A|``, past ~88 ``exp`` is ``inf``
  in f32, and the reference's backward multiplies a zero cotangent by it:
  a NaN gradient of ``dt`` (and so of ``a_log``, ``dt_bias``, ``in_dt``)
  at mamba2-780m's chunk of 256.  Here the masked entries are
  ``exp(-inf) = 0`` with a zero derivative, and the gradient stays
  finite; where both are finite the values are the same.
* ``softplus`` is the reference's ``jax.nn.softplus``, ``logaddexp(x,
  0) = max(x, 0) + log1p(exp(-|x|))``, in that form (torch's
  ``softplus`` switches to the identity above 20).
* A prefill's conv tail is the last ``d_conv - 1`` rows of ``concat(
  history, xbc)``.  On an empty cache, and for any call of at least
  ``d_conv - 1`` tokens, that is the reference's ``xbc[:, -(d_conv-1):]``
  bit for bit; for a shorter call onto a non-empty cache the reference
  zero-pads and loses the history (its next decode step differs from the
  full forward), the port keeps it.

Caches are updated in place (``conv`` and ``state`` keep their
addresses, so a CUDA graph can replay a decode step over them); the
reference returns a new cache.

Tensor parallelism (a model split installed, the reference's default
rules): where the head count divides the model axis a rank holds whole
SSD heads, read off its weights (``_local_heads``): ``in_z`` / ``in_x``
/ ``in_dt`` column-parallel, ``out_proj`` row-parallel, the conv's
``x`` channels and ``norm_scale`` its blocks, and ``in_b`` / ``in_c``
(with their conv) column-parallel where the group count divides the
axis too.  The SSD runs on the rank's heads alone: its math is per head,
so the pre-norm ``y`` is one process's columns.  Leaves kept whole but
read in part (``dt_bias`` / ``a_log`` / ``d_skip`` per head, whole B / C
per group) pass through ``model_grad_sum`` first, so their gradient is
the group's sum, the same on every rank.  The gated norm's mean of
squares runs over the whole ``d_inner``: the ranks' partial sums are
summed both ways (``nn.layers.rms_norm(width=)``).  Where the heads do
not divide the axis every leaf is whole and the mixer runs as one
process on every rank.  A cache (serving) under a split raises.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F_nn
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import model_grad_sum
from repro_torch.core.quantize import model_split
from repro_torch.core.recipe import MatmulRecipe
from repro_torch.nn.layers import linear, rms_norm, silu
from repro_torch.nn.params import ParamSpec

__all__ = ["mamba_param_specs", "mamba_mixer", "mamba_cache_spec",
           "init_mamba_cache", "ssd_chunked", "ssd_reference", "softplus"]


def _dims(cfg: ModelConfig):
    st = cfg.mamba
    d_inner = st.expand * cfg.d_model
    nheads = d_inner // st.headdim
    conv_dim = d_inner + 2 * st.n_groups * st.d_state
    return st, d_inner, nheads, conv_dim


def mamba_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The reference's specs: split projections, split depthwise conv,
    f32 ``dt_bias`` / ``a_log`` / ``d_skip``."""
    st, d_inner, nheads, _ = _dims(cfg)
    d = cfg.d_model
    gn = st.n_groups * st.d_state
    conv_scale = 1.0 / math.sqrt(st.d_conv)
    f32 = torch.float32
    return {
        "in_z": ParamSpec((d, d_inner), ("embed", "mamba_inner")),
        "in_x": ParamSpec((d, d_inner), ("embed", "mamba_inner")),
        "in_b": ParamSpec((d, gn), ("embed", "mamba_groups")),
        "in_c": ParamSpec((d, gn), ("embed", "mamba_groups")),
        "in_dt": ParamSpec((d, nheads), ("embed", "mamba_heads")),
        "conv_wx": ParamSpec((st.d_conv, d_inner), (None, "mamba_inner"),
                             scale=conv_scale),
        "conv_wb": ParamSpec((st.d_conv, gn), (None, "mamba_groups"),
                             scale=conv_scale),
        "conv_wc": ParamSpec((st.d_conv, gn), (None, "mamba_groups"),
                             scale=conv_scale),
        "conv_bx": ParamSpec((d_inner,), ("mamba_inner",), init="zeros"),
        "conv_bb": ParamSpec((gn,), ("mamba_groups",), init="zeros"),
        "conv_bc": ParamSpec((gn,), ("mamba_groups",), init="zeros"),
        "dt_bias": ParamSpec((nheads,), (None,), init="dt_bias", dtype=f32),
        "a_log": ParamSpec((nheads,), (None,), init="a_log", dtype=f32),
        "d_skip": ParamSpec((nheads,), (None,), init="ones", dtype=f32),
        "norm_scale": ParamSpec((d_inner,), ("mamba_inner",), init="zeros"),
        "out_proj": ParamSpec((d_inner, d), ("mamba_inner", "embed"),
                              scale=1.0 / math.sqrt(
                                  d_inner * max(cfg.n_layers, 1))),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _rep_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), head i reading group i // (H / G)."""
    b, s, g, n = x.shape
    if g == h:
        return x
    return x[:, :, :, None, :].expand(b, s, g, h // g, n).reshape(b, s, h, n)


def ssd_chunked(x, dt, a, bmat, cmat, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in f32.

    x (B, S, H, P); dt (B, S, H), post-softplus; a (H,), negative; bmat /
    cmat (B, S, G, N); S a multiple of ``chunk`` (callers pad);
    initial_state (B, H, P, N) or None.  Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) f32).  The chunk states' recurrence
    is a Python loop (the reference's ``scan`` and ``unroll`` compute the
    same thing).  Runs under a ``record_function("ssd")`` span, so a
    profile names its share."""
    with record_function("ssd"):
        return _ssd(x, dt, a, bmat, cmat, chunk, initial_state)


def _ssd(x, dt, a, bmat, cmat, chunk, initial_state):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    # (b, c, h, q, .) layouts: the heads batch the products
    dtf = dt.to(f32)
    cs = torch.cumsum((dtf * a.to(f32)).reshape(b, nc, chunk, h),
                      dim=2).permute(0, 1, 3, 2)                # (b,c,h,q)
    xdt = (x.to(f32) * dtf[..., None]).reshape(
        b, nc, chunk, h, p).permute(0, 1, 3, 2, 4)             # (b,c,h,k,p)
    bh = _rep_heads(bmat, h).to(f32).reshape(
        b, nc, chunk, h, n).permute(0, 1, 3, 2, 4)             # (b,c,h,k,n)
    ch = _rep_heads(cmat, h).to(f32).reshape(
        b, nc, chunk, h, n).permute(0, 1, 3, 2, 4)             # (b,c,h,q,n)

    # Intra-chunk: the masked attention-like product.  The mask goes in
    # before the exp (module docstring: a finite gradient where the
    # reference's is NaN).
    seg = cs[..., :, None] - cs[..., None, :]                  # (b,c,h,q,k)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    L = torch.exp(torch.where(tri, seg, -math.inf))
    cb = torch.matmul(ch, bh.transpose(-1, -2))                # (b,c,h,q,k)
    y_diag = torch.matmul(cb * L, xdt)                         # (b,c,h,q,p)

    # Per-chunk end states, (b, c, h, p, n)
    decay_states = torch.exp(cs[..., -1:] - cs)                # (b,c,h,k)
    states = torch.matmul(xdt.transpose(-1, -2),
                          bh * decay_states[..., None])

    # Inter-chunk recurrence over the chunk states
    chunk_decay = torch.exp(cs[..., -1])                       # (b,c,h)
    st = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
          if initial_state is None else initial_state.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(st)
        st = st * chunk_decay[:, c][:, :, None, None] + states[:, c]
    s_prev = torch.stack(prevs, dim=1)                         # (b,c,h,p,n)

    # Off-diagonal: the carried-in state, decayed to each position
    y_off = torch.matmul(ch, s_prev.transpose(-1, -2)) * \
        torch.exp(cs)[..., None]                               # (b,c,h,q,p)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y.to(x.dtype), st


def ssd_reference(x, dt, a, bmat, cmat,
                  initial_state: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32):
    """Sequential recurrence oracle (tests): one step at a time in
    ``dtype`` (the reference's f32, or f64 for a tighter oracle)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    bh = _rep_heads(bmat, h).to(dtype)
    ch = _rep_heads(cmat, h).to(dtype)
    dtf, xf, af = dt.to(dtype), x.to(dtype), a.to(dtype)
    st = (torch.zeros((b, h, p, n), dtype=dtype, device=x.device)
          if initial_state is None else initial_state.to(dtype))
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * af)                          # (b,h)
        upd = (xf[:, t] * dtf[:, t][..., None])[..., None] * \
            bh[:, t][:, :, None, :]
        st = st * dA[:, :, None, None] + upd
        ys.append((ch[:, t][:, :, None, :] * st).sum(-1))
    return torch.stack(ys, dim=1).to(x.dtype), st


# ---------------------------------------------------------------------------
# Caches and the conv
# ---------------------------------------------------------------------------

def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype
                     ) -> Dict[str, tuple]:
    """Cache of ONE mamba layer, ``{name: (shape, dtype)}``: the conv's
    last ``d_conv - 1`` inputs in ``dtype`` and the f32 SSM state.  Its
    size does not depend on the sequence's length."""
    st, _, nheads, conv_dim = _dims(cfg)
    return {"conv": ((batch, st.d_conv - 1, conv_dim), dtype),
            "state": ((batch, nheads, st.headdim, st.d_state),
                      torch.float32)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device
                     ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba_cache_spec(cfg, batch,
                                                   dtype).items()}


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d, the reference's unrolled shifts.  xbc
    (B, S, C), w (K, C), history (B, K - 1, C) or None (zeros)."""
    k, s = w.shape[0], xbc.shape[1]
    if history is None:
        history = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                              dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([history, xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i]
    return out + bias


# ---------------------------------------------------------------------------
# Mixer sublayer
# ---------------------------------------------------------------------------

def _gated_norm(v: torch.Tensor, scale: torch.Tensor, d_inner: int
                ) -> torch.Tensor:
    """``rms_norm`` of ``v`` over the whole ``d_inner``, of which ``v``
    may hold a rank's columns (module docstring)."""
    return rms_norm(v, scale, width=d_inner)


def _local_heads(params, cfg: ModelConfig):
    """``(heads, first head, the heads' tp, B / C's tp, the groups the
    heads read of whole B / C or None)`` of the weights this rank holds:
    the config's counts on one process (or heads kept whole); under a
    model split the rank's ``nh`` heads from ``index * nh``, its groups
    when ``in_b`` is a block, else an index of the whole groups (a slice
    where the heads read them evenly)."""
    st, _, nheads, _ = _dims(cfg)
    nh = params["in_dt"].shape[-1]
    gl = params["in_b"].shape[-1] // st.d_state
    if nh == nheads:
        if gl != st.n_groups:
            raise ValueError("B / C groups split over the model axis "
                             "under whole heads")
        return nh, 0, None, None, None
    split = model_split()
    if split is None or split.size * nh != nheads:
        raise ValueError(f"in_dt holds {nh} of {nheads} heads outside a "
                         "model split of that size")
    h0 = split.index * nh
    if gl != st.n_groups:
        if gl * split.size != st.n_groups:
            raise ValueError(f"in_b holds {gl} of {st.n_groups} groups "
                             f"on a model axis of {split.size}")
        return nh, h0, "col", "col", None
    rep = nheads // st.n_groups            # heads a group
    if nh % rep == 0 or rep % nh == 0:
        first = h0 // rep
        return nh, h0, "col", None, slice(first, first + max(1, nh // rep))
    return nh, h0, "col", None, [h // rep for h in range(h0, h0 + nh)]


def mamba_mixer(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, recipe: MatmulRecipe, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                decode: bool = False) -> torch.Tensor:
    """Mamba2 block, (B, S, D) -> (B, S, D).  Training: no cache.
    Prefill: ``cache`` (its state and conv history carried in) is
    updated in place.  Decode: S == 1, the cache consumed and updated in
    place.  Under a model split, the rank's heads (module docstring)."""
    st, d_inner, nheads, _ = _dims(cfg)
    b, s, _ = x.shape
    gn = st.n_groups * st.d_state
    f32 = torch.float32
    nh, h0, h_tp, g_tp, pick = _local_heads(params, cfg)
    if h_tp is not None and cache is not None:
        raise NotImplementedError("a mamba cache under a model split: "
                                  "the port serves on one process")

    z = linear(x, params["in_z"], recipe, cfg, tp=h_tp)
    xr = linear(x, params["in_x"], recipe, cfg, tp=h_tp)
    br = linear(x, params["in_b"], recipe, cfg, tp=g_tp)
    cr = linear(x, params["in_c"], recipe, cfg, tp=g_tp)
    dt_raw = linear(x, params["in_dt"], recipe, cfg, tp=h_tp)
    dt_bias, a_log, d_skip = (params[k] for k in ("dt_bias", "a_log",
                                                  "d_skip"))
    if h_tp is not None:     # whole leaves read per head
        heads = slice(h0, h0 + nh)
        dt_bias, a_log, d_skip = (model_grad_sum(t)[heads]
                                  for t in (dt_bias, a_log, d_skip))
    a = -torch.exp(a_log.to(f32))

    if decode:
        if cache is None or s != 1:
            raise ValueError("a decode step takes one token and a cache")
        xbc = torch.cat([xr, br, cr], dim=-1)
        hist = cache["conv"].to(xbc.dtype)
        cw = torch.cat([params["conv_wx"], params["conv_wb"],
                        params["conv_wc"]], dim=-1)
        cbias = torch.cat([params["conv_bx"], params["conv_bb"],
                           params["conv_bc"]], dim=-1)
        xbc_c = silu(_causal_conv(xbc, cw, cbias, hist))
        new_conv = torch.cat([hist, xbc], dim=1)[:, 1:]
        xs = xbc_c[..., :d_inner].reshape(b, nheads, st.headdim)
        bmat = xbc_c[..., d_inner:d_inner + gn].reshape(
            b, st.n_groups, st.d_state)
        cmat = xbc_c[..., d_inner + gn:].reshape(b, st.n_groups, st.d_state)
        rep = nheads // st.n_groups
        bh = bmat.repeat_interleave(rep, dim=1).to(f32)
        chh = cmat.repeat_interleave(rep, dim=1).to(f32)
        dt = softplus(dt_raw[:, 0].to(f32) + dt_bias)            # (b,h)
        dA = torch.exp(dt * a)
        upd = (xs.to(f32) * dt[..., None])[..., None] * bh[:, :, None, :]
        state = cache["state"] * dA[:, :, None, None] + upd
        # an elementwise product and a sum over N: no batched GEMM, whose
        # algorithm (and so its bits) would depend on the batch's size
        y = (chh[:, :, None, :] * state).sum(-1)                 # (b,h,p)
        y = y + d_skip[:, None] * xs.to(f32)
        y = y.reshape(b, 1, d_inner).to(x.dtype)
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)
    else:
        init_state = None if cache is None else cache["state"]
        hx = hb = hc = hist = None
        if cache is not None:
            hist = cache["conv"].to(xr.dtype)
            hx, hb, hc = (hist[..., :d_inner],
                          hist[..., d_inner:d_inner + gn],
                          hist[..., d_inner + gn:])
        x_c = silu(_causal_conv(xr, params["conv_wx"], params["conv_bx"],
                                hx))
        b_c = silu(_causal_conv(br, params["conv_wb"], params["conv_bb"],
                                hb))
        c_c = silu(_causal_conv(cr, params["conv_wc"], params["conv_bc"],
                                hc))
        xs = x_c.reshape(b, s, nh, st.headdim)
        bmat = b_c.reshape(b, s, -1, st.d_state)
        cmat = c_c.reshape(b, s, -1, st.d_state)
        if pick is not None:    # whole groups: the ones the heads read
            bmat = model_grad_sum(bmat)[:, :, pick]
            cmat = model_grad_sum(cmat)[:, :, pick]
        dt = softplus(dt_raw.to(f32) + dt_bias)
        chunk = min(st.chunk, s)
        pad = (-s) % chunk
        xs_p, dt_p, b_p, c_p = xs, dt, bmat, cmat
        if pad:   # zero steps: dt = 0 leaves the state as it is
            xs_p = F_nn.pad(xs, (0, 0, 0, 0, 0, pad))
            dt_p = F_nn.pad(dt, (0, 0, 0, pad))
            b_p = F_nn.pad(bmat, (0, 0, 0, 0, 0, pad))
            c_p = F_nn.pad(cmat, (0, 0, 0, 0, 0, pad))
        y, final_state = ssd_chunked(xs_p, dt_p, a, b_p, c_p, chunk=chunk,
                                     initial_state=init_state)
        y = y[:, :s].to(f32)
        y = y + d_skip[:, None] * xs.to(f32)
        y = y.reshape(b, s, nh * st.headdim).to(x.dtype)
        if cache is not None:
            # the conv's history for the next call: the last d_conv - 1
            # inputs, taken from the old history where this call is
            # shorter (module docstring)
            xbc = torch.cat([xr, br, cr], dim=-1)
            tail = torch.cat([hist, xbc], dim=1)[:, -(st.d_conv - 1):]
            cache["conv"].copy_(tail)
            cache["state"].copy_(final_state)

    y = _gated_norm(y * silu(z), params["norm_scale"], d_inner)
    return linear(y, params["out_proj"], recipe, cfg,
                  tp="row" if h_tp else None)
