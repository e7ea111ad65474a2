"""Mixture-of-Experts FFN: GShard-style top-k routing with capacity
dispatch (counterpart of ``repro.models.moe``).

The expert matmuls are FFN-class linears: they run the layer's
``ffn_linear`` cell of the plan, as one batched quantized matmul over
the experts (``core.qlinear.qmatmul`` on (E, C, K) x (E, K, N) operands,
one batched kernel launch a role under ``linear_impl="pallas"``, the
counterpart of the reference's ``jax.vmap`` over its matmul).  The
router stays in f32.

Routing is the reference's, bit for bit on equal logits: tokens are cut
into router groups of ``group_size`` (the last one zero-padded: the pad
rows are routed like any token, with uniform probabilities, and take
capacity slots, as in the reference), each token picks its top-k experts
(ties go to the lowest expert index: a stable descending sort, which
``jax.lax.top_k`` equals and ``torch.topk`` does not), the gates are
renormalized, and each (token, k) takes the next slot of its expert's
queue in the order k-major, token-minor; past ``capacity`` it is
dropped.  The reference dispatches and combines with one-hot einsums;
here both are index operations that give the same values: the dispatch
is an exact selection (a gather of token rows into the expert slots,
whose backward sums each token's k slot gradients in a fixed order),
and the combine gathers each token's k expert rows and sums them
weighted by their gates (rounded to the compute dtype, as the
reference's einsum rounds its combine tensor) in f32, in k order, the
same for every batch size.  Nothing here reads a device value on the
host, so a decode step can be captured into a CUDA graph.

Inside a data-parallel token split (``core.quantize.TokenSplit``: the
reference's step is the one-device function of the global batch) a rank
must hold whole router groups, so its token count must be a multiple of
``group_size`` (``ValueError`` otherwise); routing and capacity are then
per group, the rank's own.  The load-balancing loss multiplies two means
over every token: the expert-count fractions (no gradient) are
all-reduced over the group, so that the mean of the ranks' losses, and of
their gradients, is the global batch's.  The router z-loss and the drop
fraction are means of per-token terms: the ranks' mean is the global one.

On a model axis (``core.quantize.ModelSplit``) the reference's rules put
the ``experts`` axis on ``model`` where the expert count divides it, and
give ``mlp`` the axis inside every expert where it does not; the rank's
expert leaves are those blocks, and the tokens are split over the data
axes alone, so every model rank holds, routes and combines the same
tokens.

* Expert parallelism (E % m == 0): rank r holds experts ``[r E/m, (r +
  1) E/m)``.  The dispatch fills only those experts' slots, (E/m, G C,
  D); their linears run as one batched launch a role; ``out_e`` is
  all-gathered over the model group (tag ``ep_fwd``) and the combine runs
  as one process's.  The cotangent of the gathered ``out_e`` is the same
  on every rank, so each takes its own block (a reduce-scatter would
  multiply it by m); the local experts' input cotangent is all-gathered
  (tag ``ep_bwd``) and the dispatch's backward sums each token's k slot
  gradients over all slots, as one process does.  The sublayer's output,
  its input cotangent and the router's gradient are then one process's
  bits on every model rank.  The cost: each gather receives (m - 1) / m
  of the full E G C x D buffer a rank in the compute dtype; for
  olmoe-1b-7b at 2 x 2048 tokens (group 1024, capacity 160: 40,960 rows
  of 2048) a full ``out_e`` is 167.8 MB and each gather receives 83.9 MB
  a rank at m = 2, where an f32 all-reduce of each rank's partial combine
  would move 33.5 MB but lose the bits (and the router's gradient would
  then need a model-group sum).
* Inside every expert (E % m != 0): ``w_gate`` / ``w_up`` are
  column-parallel over ``d_ff``, ``w_down`` row-parallel
  (``qmatmul(..., tp=)`` on the batched operands); ``out_e``'s partial
  sums are all-reduced in f32 and rounded once (tag ``tp_fwd``), the
  cotangent of the replicated expert input likewise (``tp_bwd``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.core.packed import PackedTensor
from repro_torch.core.qlinear import model_grad_sum, model_sum, qmatmul
from repro_torch.core.quantize import model_split, token_split
from repro_torch.distributed import comms
from repro_torch.core.recipe import MatmulRecipe
from repro_torch.nn.layers import ACTIVATIONS
from repro_torch.nn.params import ParamSpec
from repro_torch.telemetry import collect as telemetry

__all__ = ["moe_param_specs", "moe", "router_loss", "route",
           "router_logits", "expert_linear", "gather_experts",
           "partial_combine", "ROUTER_ROWS"]

# The router matmul's rows are padded to a multiple of this
# (``router_logits``)
ROUTER_ROWS = 16


def moe_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    down_scale = 1.0 / math.sqrt(f * max(cfg.n_layers, 1))
    specs = {
        "router": ParamSpec((d, e), ("embed", None), dtype=torch.float32),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), ("experts", "mlp", "embed"),
                            scale=down_scale),
    }
    if cfg.activation == "swiglu":
        specs["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"))
    return specs


def expert_linear(x: torch.Tensor, w, recipe: MatmulRecipe,
                  impl: str = "qdq",
                  layout: Optional[str] = None) -> torch.Tensor:
    """Batched per-expert quantized matmul: (E, C, K) @ (E, K, N).  A
    ``PackedTensor`` weight is expanded per expert and then fed through
    the matmul under the recipe's ``fwd_w``, as the reference does (its
    tile blocks were packed per expert, so the expansion is the exact
    per-expert QDQ).  ``layout``: the weights' split over the model
    group (``moe``): ``"ep"``, the rank's block of the experts (the
    telemetry taps average over all of them), or ``"col"`` | ``"row"``,
    its tensor-parallel block inside every expert (a row-parallel product
    is the rank's partial sum)."""
    if isinstance(w, PackedTensor):
        w = w.dequantize().to(x.dtype)
    if recipe.is_passthrough:
        return torch.matmul(x, w)
    ep = layout == "ep"
    tp = None if ep else layout
    # no-ops unless collecting
    telemetry.tap_matmul_batched(x, w, recipe, tp=tp, ep=ep)
    y = qmatmul(x, w, recipe, impl=impl, tp=tp)
    return telemetry.grad_tap(y, recipe, tp=tp, ep=ep)


def router_logits(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(G, T, D) tokens -> (G, T, E) f32 logits.  The rows go to the
    matmul padded to a multiple of ``ROUTER_ROWS``: the library picks its
    algorithm by the shape, so a decode step of 1 slot and one of 4 slots
    would otherwise get logits that differ in the last bits; padded, both
    run one shape and every row's logits are the same."""
    g, t, d = xg.shape
    rows = xg.reshape(g * t, d).to(torch.float32)
    pad = -(g * t) % ROUTER_ROWS
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, d)])
    return torch.matmul(rows, router)[:g * t].reshape(g, t, -1)


def route(logits: torch.Tensor, top_k: int, capacity: int):
    """GShard routing of (G, T, E) f32 logits: ``(probs, gate_vals,
    expert_idx, slot, kept)``.  ``expert_idx`` / ``slot`` (G, T, K) int64:
    each (token, k)'s expert and its place in that expert's queue (k-major,
    token-minor priority); ``kept``: the slot is inside ``capacity``."""
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lowest index first among equal
    # probabilities, as jax.lax.top_k does
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    expert_idx = order[..., :top_k]
    gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    g, t, e = logits.shape
    experts = torch.arange(e, device=logits.device)
    onehot = (expert_idx[..., None] == experts).to(torch.int32)  # (G,T,K,E)
    flat = onehot.transpose(1, 2).reshape(g, top_k * t, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, top_k, t, e)
    slot = torch.gather(pos.transpose(1, 2), -1,
                        expert_idx[..., None]).squeeze(-1).to(torch.int64)
    return probs, gate_vals, expert_idx, slot, slot < capacity


class _Dispatch(torch.autograd.Function):
    """Rows of ``x`` (N, D) into expert slots: ``out[s] = x[src[s]]``,
    zero where ``src[s] == N``.  The backward gathers each token's k slot
    gradients (``dst`` (N, K), the slot of each of its picks, or the
    empty slot) and sums them in k order.  Under expert parallelism
    (``split``: the model split) ``src`` is the rank's own slots and the
    backward first all-gathers every rank's slot gradients (tag
    ``ep_bwd``), so that each token's sum is one process's."""

    @staticmethod
    def forward(ctx, x, src, dst, split=None):
        ctx.save_for_backward(dst)
        ctx.split, ctx.layer = split, routing.current_layer()
        xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
        return xz.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        if ctx.split is not None:
            g = comms.all_gather(g.contiguous(), ctx.split.group,
                                 tag="ep_bwd", layer=ctx.layer)
            g = g.reshape(-1, g.shape[-1])
        gz = torch.cat([g, g.new_zeros(1, g.shape[1])])
        dx = None
        for j in range(dst.shape[1]):
            part = gz.index_select(0, dst[:, j])
            dx = part if dx is None else dx + part
        return dx, None, None, None


class _ExpertGather(torch.autograd.Function):
    """Expert parallelism: every model rank's expert outputs (E/m, R, D)
    gathered in rank order into (E, R, D) (tag ``ep_fwd``).  The
    cotangent of the gathered tensor is the same on every rank (the
    combine after it runs alike everywhere): the backward takes the
    rank's own block."""

    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        parts = comms.all_gather(y.contiguous(), split.group, tag="ep_fwd",
                                 layer=routing.current_layer())
        return parts.reshape(-1, *y.shape[1:])

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // ctx.split.size
        return g.narrow(0, ctx.split.index * n, n), None


# set while ``partial_combine`` is entered
_PARTIAL = [False]


def gather_experts(y: torch.Tensor, split) -> torch.Tensor:
    """The whole (E, R, D) expert output from the rank's (E/m, R, D)
    block (``_ExpertGather``); inside ``partial_combine`` the rank's block
    among zeros, with no collective."""
    if _PARTIAL[0]:
        n = y.shape[0]
        zeros = y.new_zeros((n * split.size,) + tuple(y.shape[1:]))
        return torch.cat([zeros[:split.index * n], y,
                          zeros[(split.index + 1) * n:]])
    return _ExpertGather.apply(y, split)


@contextlib.contextmanager
def partial_combine():
    """While entered, each expert-parallel rank combines over its own
    experts alone (the other ranks' outputs zero): the control that a
    check of the gathered sublayer must see miss."""
    _PARTIAL[0] = True
    try:
        yield
    finally:
        _PARTIAL[0] = False


def _expert_layout(params, cfg: ModelConfig):
    """``(split, layout)`` of this layer's expert leaves under the
    installed model split: ``"ep"`` where the rank holds whole experts (a
    block of dim 0), ``"mlp"`` where it holds a block of every expert's
    ``d_ff``; ``(None, None)`` on whole experts."""
    split = model_split()
    w = params["w_up"]
    if split is None or isinstance(w, PackedTensor):
        return None, None
    if w.shape[0] != cfg.moe.num_experts:
        if w.shape[0] * split.size != cfg.moe.num_experts:
            raise ValueError(f"{w.shape[0]} experts a rank of "
                             f"{cfg.moe.num_experts} on {split.size} ranks")
        return split, "ep"
    return split, ("mlp" if w.shape[-1] != cfg.d_ff else None)


def moe(params: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
        recipe: MatmulRecipe) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), aux losses: ``moe_load_balance``,
    ``moe_router_z``, ``moe_frac_dropped``)."""
    st = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    split = token_split()
    if split is not None and tokens % st.group_size:
        raise ValueError(
            f"a router group of {st.group_size} tokens straddles a "
            f"data-parallel rank boundary: each rank holds {tokens} tokens")
    gsz = min(st.group_size, tokens)
    n_groups = -(-tokens // gsz)
    pad = n_groups * gsz - tokens
    xt = x.reshape(tokens, d)
    if pad:
        xt = torch.cat([xt, xt.new_zeros(pad, d)])
    xg = xt.reshape(n_groups, gsz, d)

    # --- routing (f32) ---
    logits = router_logits(xg, params["router"])
    e, k = st.num_experts, st.top_k
    capacity = max(int(math.ceil(gsz * k * st.capacity_factor / e)), k)
    probs, gate_vals, expert_idx, slot, kept = route(logits, k, capacity)

    # --- dispatch: slot (e, g, c) of the (E, G*C, D) expert input ---
    n_tok, n_slot = n_groups * gsz, e * n_groups * capacity
    group = torch.arange(n_groups, device=x.device)[:, None, None]
    # the reference's dispatch is (combine > 0): a kept pick whose gate
    # underflowed to zero dispatches nothing
    live = kept & (gate_vals > 0)
    flat_slot = torch.where(live, (expert_idx * n_groups + group) * capacity
                            + slot, n_slot).reshape(n_tok, k)
    tok = torch.arange(n_tok, device=x.device)[:, None].expand(n_tok, k)
    src = torch.full((n_slot + 1,), n_tok, dtype=torch.int64,
                     device=x.device)
    src.scatter_(0, flat_slot.reshape(-1), tok.reshape(-1))
    msplit, layout = _expert_layout(params, cfg)
    ep, tp = layout == "ep", layout == "mlp"
    # expert parallelism: the rank's own experts' slots
    e_loc = e // msplit.size if ep else e
    lo = msplit.index * e_loc * n_groups * capacity if ep else 0
    xe = _Dispatch.apply(xt, src[lo:lo + e_loc * n_groups * capacity],
                         flat_slot, msplit if ep else None).reshape(
        e_loc, n_groups * capacity, d)

    # --- expert computation ---
    impl = cfg.linear_impl
    # each linear's layout: the rank's experts, or inside every expert
    # gate / up column-parallel and down row-parallel
    up, down = ("col", "row") if tp else (layout, layout)
    if tp:      # the replicated expert input: its cotangent summed
        xe = model_grad_sum(xe)
    if cfg.activation == "swiglu":
        g_ = expert_linear(xe, params["w_gate"], recipe, impl, up)
        u_ = expert_linear(xe, params["w_up"], recipe, impl, up)
        h = ACTIVATIONS["silu"](g_) * u_
    else:
        h = ACTIVATIONS[cfg.activation](
            expert_linear(xe, params["w_up"], recipe, impl, up))
    out_e = expert_linear(h, params["w_down"], recipe, impl, down)
    if tp:      # the row-parallel partial sums
        out_e = model_sum(out_e)
    if ep:      # (E, G*C, D) from every rank's experts
        out_e = gather_experts(out_e, msplit)

    # --- combine: each token's k expert rows, weighted, in k order ---
    rows = torch.cat([out_e.reshape(n_slot, d),
                      out_e.new_zeros(1, d)]).index_select(
        0, flat_slot.reshape(-1)).reshape(n_tok, k, d)
    w = torch.where(kept, gate_vals, 0.0).reshape(n_tok, k).to(x.dtype)
    acc = None
    for j in range(k):
        term = w[:, j, None].to(torch.float32) * rows[:, j].to(torch.float32)
        acc = term if acc is None else acc + term
    out = acc.to(x.dtype)[:tokens].reshape(b, s, d)

    # --- aux losses (Shazeer load balancing + router z-loss) ---
    me = probs.mean(dim=(0, 1))
    ce = (expert_idx[..., None] == torch.arange(e, device=x.device)).to(
        torch.float32).sum(dim=2).mean(dim=(0, 1))
    if split is not None:       # the global batch's fractions
        ce = comms.all_reduce(ce.contiguous(), "sum", split.group,
                              tag="metric") / split.size
    lb = e * torch.sum(me * ce) * st.load_balance_loss
    zl = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * st.router_z_loss
    frac_dropped = 1.0 - kept.sum().to(torch.float32) / (n_tok * k)
    return out, {"moe_load_balance": lb, "moe_router_z": zl,
                 "moe_frac_dropped": frac_dropped}


def router_loss(aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    return aux["moe_load_balance"] + aux["moe_router_z"]
