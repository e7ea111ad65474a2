"""Model API for every family: init, loss, forward, prefill,
decode_step (counterpart of ``repro.models.model``).

Parameters are a nested dict mirroring the reference's tree; precision
enters through the ``plan`` argument (a ``PrecisionPlan``, or a
``PrecisionRecipe`` coerced to the uniform plan).  ``loss`` and
``hidden`` run under autograd (training); the serving entry points run
without it.

The cross-attention families take their states from the batch: a vlm's
``vision`` (B, n_patches, d_model), cast to the compute dtype; an audio
model's ``frames`` (B, n_frames, d_model), run through its encoder
(``_encode``: sinusoidal positions, a non-causal stack under the plan
resized to the encoder's depth, a final norm).  ``prefill`` takes them
as ``extras`` beside its tokens; ``decode_step`` reads the cross cache
the prefill filled.

The dead encoder: the reference places a cross sublayer where ``i %
cross_attn_period == cross_attn_period - 2``, so with whisper's period of
1 no decoder layer has one, nothing reads the encoder's output, the loss
does not depend on ``frames`` and every encoder gradient is 0 (XLA drops
the encoder as dead code under ``jit``).  The port does not run
``_encode`` when no layer reads it (``reads_cross``): the loss, the
gradients and the telemetry rows are the reference's (the reference's
encoder adds no tap to them), and ``train_step`` hands the leaves of
``unread_leaves`` gradients of zeros, so AdamW moves them as the
reference's moves them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import PackedTensor
from repro_torch.core.recipe import PrecisionPlan, as_plan
from repro_torch.models import stack as stack_lib
from repro_torch.nn.layers import (apply_norm, linear, shard_hint,
                                    sincos_positions)
from repro_torch.nn.params import (ParamSpec, init_params, param_count,
                                   spec_leaves)
from repro_torch.telemetry import collect as telemetry
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Model", "build_model", "tree_map"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Aux losses that the loss adds (the reference's ``router_loss`` terms)
_LOSS_AUX = ("moe_load_balance", "moe_router_z")


def _pinned_names(specs) -> frozenset:
    """Names of the leaves whose spec pins a dtype (the MoE router,
    mamba's ``dt_bias``, ``a_log`` and ``d_skip``: f32)."""
    if isinstance(specs, dict):
        return frozenset(k for k, v in specs.items()
                         if isinstance(v, ParamSpec) and v.dtype is not None
                         ).union(*(_pinned_names(v) for v in specs.values()
                                   if not isinstance(v, ParamSpec)))
    if isinstance(specs, list):
        return frozenset().union(*(_pinned_names(v) for v in specs))
    return frozenset()


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The audio encoder's config: the decoder's widths, its own depth,
    dense, no cross sublayers, no window."""
    return cfg.replace(n_layers=cfg.n_encoder_layers, family="dense",
                       cross_attn_period=0, attn_layer_period=0, moe=None,
                       sliding_window=0)


class Model:
    """LM (attention or mamba mixers, cross-attention sublayers, dense or
    MoE FFNs or none; an audio model's encoder) on one device (``cuda``
    unless ``device`` says otherwise)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]
        # Leaves that keep their spec's dtype in ``cast_params``
        self._keep_dtype = _pinned_names(self.param_specs())
        specs = cfg.layer_specs()
        # A prefill that must run at the prompt's exact length: a ring
        # window's pad would overwrite ring slots, an SSM's state would
        # take in the pad tokens
        self.exact_prefill = bool(cfg.sliding_window) or any(
            s.mixer != "attn" for s in specs)
        # Whether a layer reads the cross states: not whisper's decoder
        # (module docstring, the dead encoder)
        self.reads_cross = any(s.cross for s in specs)

    # -- parameters ----------------------------------------------------

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        specs: Dict[str, Any] = {
            "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                               init="embed"),
            "final_norm": stack_lib.norm_specs(cfg),
            "stack": stack_lib.stack_param_specs(cfg),
        }
        if cfg.pos_emb == "learned":
            specs["pos_embed"] = ParamSpec((cfg.max_seq_len, d),
                                           (None, "embed"), init="embed")
        if not cfg.tie_embeddings:
            specs["head"] = ParamSpec((d, cfg.vocab_size),
                                      ("embed", "vocab"),
                                      scale=1.0 / math.sqrt(d))
        if self.cfg.family == "audio":
            enc = _encoder_cfg(cfg)
            specs["encoder"] = {"stack": stack_lib.stack_param_specs(enc),
                                "final_norm": stack_lib.norm_specs(enc)}
        return specs

    def unread_leaves(self, params) -> list:
        """The parameter leaves that no layer reads: a dead encoder's
        (module docstring); none in every other model."""
        if "encoder" in params and not self.reads_cross:
            return tree_leaves(params["encoder"])
        return []

    def init(self, seed: int = 0, dtype=torch.float32,
             on_device: bool = False):
        """Seeded init (truncated normal, fan-in scaled), f32 master
        weights on the model's device, drawn on the CPU (the same weights
        on every device) or, with ``on_device``, on the model's device."""
        return init_params(self.param_specs(), seed, dtype, self.device,
                           on_device)

    def param_count(self) -> int:
        return param_count(self.param_specs())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts of every
        expert leaf), as the reference counts them."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.moe is None:
            return total
        expert = sum(math.prod(s.shape)
                     for s in spec_leaves(self.param_specs())
                     if "experts" in s.axes)
        inactive = expert * (1.0 - cfg.moe.top_k / cfg.moe.num_experts)
        return int(total - inactive)

    def cast_params(self, params):
        """Floating tensors to the compute dtype, except the leaves whose
        spec pins an f32 dtype (the MoE router, mamba's ``dt_bias``,
        ``a_log`` and ``d_skip``), as the reference casts;
        PackedTensor leaves pass through (they expand at their matmul).  A
        tensor already in its dtype is returned as is, so casting once up
        front makes later calls free."""
        def cast(tree, name=None):
            if isinstance(tree, dict):
                return {k: cast(v, k) for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v, name) for v in tree]
            if isinstance(tree, PackedTensor) or \
                    not tree.is_floating_point() or \
                    name in self._keep_dtype:
                return tree
            return tree.to(self.dtype)
        return cast(params)

    # -- embedding / head ------------------------------------------------

    def _embed(self, params, tokens, positions):
        # F.embedding, not indexing: its CPU backward sums each row's
        # gradients in one fixed order, where indexing's (index_put_ with
        # accumulate) adds them in parallel in any order, so two runs of
        # the same step would differ in the embedding's last bits
        x = F.embedding(tokens, params["embed"]).to(self.dtype)
        if self.cfg.pos_emb == "learned":
            pe = F.embedding(positions, params["pos_embed"]).to(self.dtype)
            x = x + (pe if positions.dim() == tokens.dim() else pe[None])
        return shard_hint(x, ("batch", "seq", "embed"))

    def _head(self, params, x, plan: PrecisionPlan):
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        w = (params["embed"].to(self.dtype).T if self.cfg.tie_embeddings
             else params["head"].to(self.dtype))
        with telemetry.module_scope("head"):
            logits = linear(x, w, plan.head_linear, self.cfg)
        return shard_hint(logits, ("batch", "seq", "vocab"))

    def _plan(self, p) -> PrecisionPlan:
        return as_plan(p, self.cfg.n_layers)

    # -- cross states (vlm, audio) ----------------------------------------

    def _encode(self, params, frames: torch.Tensor,
                plan: PrecisionPlan) -> torch.Tensor:
        """frames (B, F, D), the stubbed conv frontend's embeddings: plus
        sinusoidal positions, through the encoder stack (non-causal, the
        decoder's plan resized onto its depth, backward taps folded into
        the class rows) and its final norm.  ``params`` in the compute
        dtype."""
        enc = _encoder_cfg(self.cfg)
        x = frames.to(self.dtype)
        x = x + sincos_positions(x.shape[1], enc.d_model,
                                 x.device).to(self.dtype)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        x = stack_lib.run_stack(params["encoder"]["stack"], enc,
                                plan.resize(enc.n_layers), x,
                                positions=positions, causal=False,
                                indexed_probes=False)
        return apply_norm(params["encoder"]["final_norm"], x, enc.norm)

    def _cross_states(self, params, extras, plan) -> Optional[torch.Tensor]:
        """The states the cross sublayers attend to, from ``extras`` (a
        batch's or a prefill's): ``vision`` cast to the compute dtype, or
        ``frames`` through the encoder; None for a family with none, or
        where no layer reads them (the dead encoder)."""
        if not self.reads_cross:
            return None
        if self.cfg.family == "vlm":
            return extras["vision"].to(self.dtype)
        if self.cfg.family == "audio":
            return self._encode(params, extras["frames"], plan)
        return None

    # -- training forward / loss (no cache) -----------------------------

    def _body(self, params, tokens: torch.Tensor, plan, aux=None,
              extras=None):
        """(compute-dtype params, plan, the stack's output) of a forward
        with no cache; per-layer telemetry stats go into ``aux``."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self._embed(params, tokens, positions)
        cross = self._cross_states(params, extras, plan)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cross_states=cross,
                                aux=aux)
        return params, plan, x

    def _logits(self, params, tokens: torch.Tensor, plan,
                aux=None, extras=None) -> torch.Tensor:
        params, plan, x = self._body(params, tokens, plan, aux, extras)
        return self._head(params, x, plan)

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor, plan, *,
                extras: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """Logits of every position, (B, S, V) — teacher forcing.  A vlm
        or audio model takes its ``vision`` / ``frames`` in ``extras``."""
        return self._logits(params, tokens, plan, extras=extras)

    def hidden(self, params, batch: Dict[str, torch.Tensor], plan
               ) -> torch.Tensor:
        """Training-mode forward up to (excluding) the LM head: the final
        norm's output."""
        params, _, x = self._body(params, batch["tokens"], plan,
                                  extras=batch)
        return apply_norm(params["final_norm"], x, self.cfg.norm)

    @staticmethod
    def _xent_terms(logits: torch.Tensor, targets: torch.Tensor):
        """(sum nll, sum lse^2, n_tokens) over positions with target >= 0,
        in f32."""
        mask = targets >= 0
        lt = torch.where(mask, targets, torch.zeros_like(targets)).long()
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lt[..., None]).squeeze(-1)
        nll = ((lse - gold) * mask).sum()
        z2 = ((lse * mask) ** 2).sum()
        return nll, z2, mask.sum()

    def loss(self, params, batch: Dict[str, torch.Tensor], plan
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy (f32) under autograd; ``targets == -1``
        masks a position.  Returns (loss, metrics) with the reference's
        metric names (``loss``, ``tokens``, ``z_loss`` when set,
        ``total_loss``, and the per-layer ``tel/l{i:02d}/...`` stats when
        a telemetry collector is installed).  A MoE model adds its summed
        ``moe_load_balance`` and ``moe_router_z`` to the loss and reports
        them and ``moe_frac_dropped``, as the reference does.

        With ``cfg.loss_chunk > 0`` the head matmul and the xent run
        seq-chunked, each chunk rematerialized (``stack.remat``'s
        checkpoint, whatever ``cfg.remat`` says, as the reference's
        ``jax.checkpoint``), so the (B, S, vocab) logits never exist at
        once; telemetry is off inside a chunk, as in the reference."""
        cfg = self.cfg
        aux: Dict[str, torch.Tensor] = {}
        targets = batch["targets"]
        if not cfg.loss_chunk:
            logits = self._logits(params, batch["tokens"], plan, aux,
                                  extras=batch)
            nll, z2, n = self._xent_terms(logits, targets)
        else:
            params, plan, x = self._body(params, batch["tokens"], plan, aux,
                                         extras=batch)
            h = apply_norm(params["final_norm"], x, cfg.norm)
            w = (params["embed"].T if cfg.tie_embeddings
                 else params["head"])
            c, s = cfg.loss_chunk, h.shape[1]
            if s % c:
                raise ValueError(f"seq {s} does not split into loss "
                                 f"chunks of {c}")
            chunk_cfg = dataclasses.replace(cfg, remat=True,
                                            remat_policy="full")
            nll = z2 = n = None
            for j in range(s // c):
                t_c = targets[:, j * c:(j + 1) * c]

                def terms(h_c, aux_ok, t_c=t_c):
                    with telemetry.suppressed():
                        logits = linear(h_c, w, plan.head_linear, cfg)
                    return torch.stack(self._xent_terms(logits, t_c)[:2])

                d = stack_lib.remat(terms, h[:, j * c:(j + 1) * c],
                                    chunk_cfg)
                d_n = (t_c >= 0).sum()
                nll, z2, n = ((d[0], d[1], d_n) if nll is None else
                              (nll + d[0], z2 + d[1], n + d_n))
        denom = torch.clamp(n, min=1)
        loss = nll / denom
        metrics = {"loss": loss, "tokens": denom}
        if cfg.z_loss:
            zl = cfg.z_loss * z2 / denom
            loss = loss + zl
            metrics["z_loss"] = zl
        for k, v in aux.items():
            metrics[k] = v
            if k in _LOSS_AUX:
                loss = loss + v
        metrics["total_loss"] = loss
        return loss, metrics

    # -- serving ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   per_slot: bool = False):
        """The serving cache, one per layer: an attention layer's K/V
        (``max_len`` positions), a mamba layer's conv history and f32
        state (constant in ``max_len``), a cross layer's K/V over the
        states (in the compute dtype: the reference's prefill replaces
        its cross cache with the K/V it projects); ``per_slot`` gives
        every row its own length (``length`` (batch,)) and position
        track."""
        return {
            "stack": stack_lib.init_stack_cache(self.cfg, batch, max_len,
                                                dtype, self.device,
                                                per_slot, self.dtype),
            "length": torch.zeros((batch,) if per_slot else (),
                                  dtype=torch.int32, device=self.device),
        }

    def reset_cache(self, cache) -> None:
        """Empty ``cache`` in place, as ``init_cache`` made it: no key
        at any position, zero SSM state, conv history and cross K/V,
        length 0."""
        for layer in cache["stack"]["layers"]:
            for key, t in [*layer["self"].items(),
                           *layer.get("cross", {}).items()]:
                if key == "pos":
                    t.fill_(-1)
                else:
                    t.zero_()
        cache["length"].zero_()

    def check_ring_prefill(self, cache, n_tokens: int,
                           cached: Optional[int] = None) -> None:
        """Raise ``ValueError`` if a prefill of ``n_tokens`` into ``cache``
        would evict keys its own queries need: under a sliding window the
        cache is a ring, each call writes all its K/V before it attends,
        so a call of more than one token is exact only while the cached
        length plus its tokens fits in the ring (past that it overwrites
        keys inside its first queries' windows).  A single-token call
        never raises.  ``cached`` is the cached length where the caller
        knows it; else it is read on the host (a windowed prefill is never
        captured into a CUDA graph: each length would need its own)."""
        if not self.cfg.sliding_window or n_tokens <= 1:
            return
        size = next(layer["self"]["pos"].shape[-1]
                    for layer in cache["stack"]["layers"]
                    if "pos" in layer["self"])
        if cached is None:
            cached = int(cache["length"].max())
        if cached + n_tokens > size:
            raise ValueError(
                f"a windowed prefill of {n_tokens} tokens onto {cached} "
                f"cached ones overflows the ring of {size} positions "
                f"(sliding_window {self.cfg.sliding_window}): it would "
                "evict keys that its own queries attend to; prefill at "
                "most the ring size in one call, or decode the rest one "
                "token at a time")

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache, plan, *,
                true_length=None,
                extras: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Process a prompt into ``cache`` (updated in place); returns
        (last-position logits (B, 1, V), cache).  With ``true_length`` (an
        int, or a 0-d integer tensor: a CUDA graph's device input, as the
        reference traces it) the prompt is right-padded: logits come from
        position ``true_length - 1`` and the length advances by
        ``true_length``; the padded tail's K/V sit at positions >= that
        length, masked for every later query until decode overwrites them.
        Both forms give the same bits.  A windowed cache refuses a call
        that would overflow its ring (``check_ring_prefill``).  A model
        with mamba mixers (``exact_prefill``) takes prompts at their exact
        length: its state would take in a padded tail.  A vlm or audio
        model takes its ``vision`` / ``frames`` in ``extras``: each
        prefill projects them into the cross cache again."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        sq = tokens.shape[1]
        self.check_ring_prefill(cache, sq)
        length = cache["length"]
        ar = torch.arange(sq, dtype=torch.int32, device=tokens.device)
        positions = (length[:, None] + ar[None] if length.dim()
                     else length + ar)
        x = self._embed(params, tokens, positions)
        cross = self._cross_states(params, extras, plan)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cross_states=cross,
                                cache=cache["stack"], cache_len=length)
        if true_length is None:
            x_last, advance = x[:, -1:], sq
        elif isinstance(true_length, torch.Tensor):
            advance = true_length.to(torch.int32)
            x_last = x.index_select(1, (advance - 1).reshape(1).long())
        else:
            x_last, advance = x[:, true_length - 1:true_length], true_length
        logits = self._head(params, x_last, plan)
        length.add_(advance)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache, plan, *,
                    live: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Any]:
        """One decode step: token (B, 1) -> logits (B, 1, V).  A per-slot
        cache decodes every row at its own position; with ``live`` (B,)
        bool, only the live rows' lengths advance.  Cross sublayers read
        the K/V the prefill cached."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        pos = cache["length"]
        positions = (pos[:, None] if pos.dim() else pos[None]).to(
            torch.int32)
        x = self._embed(params, token, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cache=cache["stack"],
                                cache_len=pos, decode=True)
        logits = self._head(params, x, plan)
        pos.add_(1 if live is None else live.to(pos.dtype))
        return logits, cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
