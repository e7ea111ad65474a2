"""Model API for the dense family: init, loss, forward, prefill,
decode_step (counterpart of ``repro.models.model``).

Parameters are a nested dict mirroring the reference's tree; precision
enters through the ``plan`` argument (a ``PrecisionPlan``, or a
``PrecisionRecipe`` coerced to the uniform plan).  ``loss`` and
``hidden`` run under autograd (training); the serving entry points run
without it.
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
from repro_torch.nn.layers import apply_norm, linear
from repro_torch.nn.params import ParamSpec, init_params
from repro_torch.telemetry import collect as telemetry
from repro_torch.tree import tree_map

__all__ = ["Model", "build_model", "tree_map"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model:
    """Dense decoder LM on one device (``cuda`` unless ``device`` says
    otherwise)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

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
        return specs

    def init(self, seed: int = 0, dtype=torch.float32):
        """Seeded init (truncated normal, fan-in scaled), f32 master
        weights on the model's device."""
        return init_params(self.param_specs(), seed, dtype, self.device)

    def cast_params(self, params):
        """Floating tensors to the compute dtype; PackedTensor leaves pass
        through (they expand at their matmul).  A tensor already in the
        compute dtype is returned as is, so casting once up front makes
        later calls free."""
        def cast(p):
            if isinstance(p, PackedTensor) or not p.is_floating_point():
                return p
            return p.to(self.dtype)
        return tree_map(cast, params)

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
        return x

    def _head(self, params, x, plan: PrecisionPlan):
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        w = (params["embed"].to(self.dtype).T if self.cfg.tie_embeddings
             else params["head"].to(self.dtype))
        with telemetry.module_scope("head"):
            return linear(x, w, plan.head_linear, self.cfg)

    def _plan(self, p) -> PrecisionPlan:
        return as_plan(p, self.cfg.n_layers)

    # -- training forward / loss (no cache) -----------------------------

    def _body(self, params, tokens: torch.Tensor, plan, aux=None):
        """(compute-dtype params, plan, the stack's output) of a forward
        with no cache; per-layer telemetry stats go into ``aux``."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self._embed(params, tokens, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, aux=aux)
        return params, plan, x

    def _logits(self, params, tokens: torch.Tensor, plan,
                aux=None) -> torch.Tensor:
        params, plan, x = self._body(params, tokens, plan, aux)
        return self._head(params, x, plan)

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor, plan) -> torch.Tensor:
        """Logits of every position, (B, S, V) — teacher forcing."""
        return self._logits(params, tokens, plan)

    def hidden(self, params, batch: Dict[str, torch.Tensor], plan
               ) -> torch.Tensor:
        """Training-mode forward up to (excluding) the LM head: the final
        norm's output."""
        params, _, x = self._body(params, batch["tokens"], plan)
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
        a telemetry collector is installed).

        With ``cfg.loss_chunk > 0`` the head matmul and the xent run
        seq-chunked, each chunk rematerialized (``stack.remat``'s
        checkpoint, whatever ``cfg.remat`` says, as the reference's
        ``jax.checkpoint``), so the (B, S, vocab) logits never exist at
        once; telemetry is off inside a chunk, as in the reference."""
        cfg = self.cfg
        aux: Dict[str, torch.Tensor] = {}
        targets = batch["targets"]
        if not cfg.loss_chunk:
            logits = self._logits(params, batch["tokens"], plan, aux)
            nll, z2, n = self._xent_terms(logits, targets)
        else:
            params, plan, x = self._body(params, batch["tokens"], plan, aux)
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
        metrics.update(aux)
        metrics["total_loss"] = loss
        return loss, metrics

    # -- serving ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   per_slot: bool = False):
        """KV cache; ``per_slot`` gives every row its own length
        (``length`` (batch,)) and position track."""
        return {
            "stack": stack_lib.init_stack_cache(self.cfg, batch, max_len,
                                                dtype, self.device,
                                                per_slot),
            "length": torch.zeros((batch,) if per_slot else (),
                                  dtype=torch.int32, device=self.device),
        }

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache, plan, *,
                true_length: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Process a prompt into ``cache`` (updated in place); returns
        (last-position logits (B, 1, V), cache).  With ``true_length`` the
        prompt is right-padded: logits come from position
        ``true_length - 1`` and the length advances by ``true_length``;
        the padded tail's K/V sit at positions >= that length, masked for
        every later query until decode overwrites them."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        sq = tokens.shape[1]
        length = cache["length"]
        ar = torch.arange(sq, dtype=torch.int32, device=tokens.device)
        positions = (length[:, None] + ar[None] if length.dim()
                     else length + ar)
        x = self._embed(params, tokens, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cache=cache["stack"],
                                cache_len=length)
        if true_length is None:
            x_last, advance = x[:, -1:], sq
        else:
            x_last, advance = x[:, true_length - 1:true_length], true_length
        logits = self._head(params, x_last, plan)
        cache["length"] = length + advance
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache, plan
                    ) -> Tuple[torch.Tensor, Any]:
        """One decode step: token (B, 1) -> logits (B, 1, V).  A per-slot
        cache decodes every row at its own position."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        pos = cache["length"]
        positions = (pos[:, None] if pos.dim() else pos[None]).to(
            torch.int32)
        x = self._embed(params, token, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cache=cache["stack"],
                                cache_len=pos)
        logits = self._head(params, x, plan)
        cache["length"] = pos + 1
        return logits, cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
