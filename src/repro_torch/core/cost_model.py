"""Model flop accounting (the ``ModelDims`` part of
``repro.core.cost_model``): forward matmul FLOPs per token by layer and
plan class, for tokens/s-based MFU.  The plan pricing and the measured
cost calibration of the reference module wait for the adaptive
controller."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["BlockDims", "block_flops", "LayerDims", "ModelDims"]


@dataclasses.dataclass(frozen=True)
class BlockDims:
    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    seq_len: int
    n_ff_matmuls: int = 2  # 2 for gelu MLP, 3 for swiglu
    moe_top_k: int = 1     # active experts per token (1 for dense)


def block_flops(d: BlockDims) -> Dict[str, float]:
    """Forward matmul FLOPs per token of one transformer block, by
    component: {'attn_linear', 'attn_sdpa', 'ffn'} (x2 mults + adds)."""
    dm, hd = d.d_model, d.head_dim
    q_out = d.n_heads * hd
    kv_out = 2 * d.n_kv_heads * hd
    attn_linear = 2 * dm * (q_out + kv_out) + 2 * q_out * dm  # QKV + O
    # scores QK^T + context AV, causal -> seq/2 effective
    attn_sdpa = 2 * 2 * d.n_heads * hd * (d.seq_len / 2)
    ffn = d.n_ff_matmuls * 2 * dm * d.d_ff
    if d.n_ff_matmuls == 3:  # swiglu: gate+up (dm->dff) and down (dff->dm)
        ffn = 2 * (2 * dm * d.d_ff) + 2 * d.d_ff * dm
    ffn *= d.moe_top_k
    return {"attn_linear": attn_linear, "attn_sdpa": attn_sdpa, "ffn": ffn}


@dataclasses.dataclass(frozen=True)
class LayerDims:
    """Forward matmul FLOPs per token of one layer, by plan class."""

    attn_linear: float
    attn_sdpa: float
    ffn: float


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Per-layer flops of a whole model plus the LM head's matmul."""

    layers: Tuple[LayerDims, ...]
    head_flops: float = 0.0

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def total_fwd_flops(self) -> float:
        """Forward matmul flops per token, whole model (linears, SDPA and
        the LM head)."""
        return sum(ld.attn_linear + ld.attn_sdpa + ld.ffn
                   for ld in self.layers) + self.head_flops

    @classmethod
    def from_config(cls, cfg, seq_len: Optional[int] = None,
                    include_head: bool = True) -> "ModelDims":
        """Per-layer dims of a (dense) ``ModelConfig``."""
        dm = cfg.d_model
        f = block_flops(BlockDims(
            d_model=dm, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            seq_len=seq_len or cfg.max_seq_len,
            n_ff_matmuls=3 if cfg.activation == "swiglu" else 2))
        rows = tuple(LayerDims(f["attn_linear"], f["attn_sdpa"], f["ffn"])
                     for _ in cfg.layer_specs())
        return cls(rows, 2.0 * dm * cfg.vocab_size if include_head else 0.0)
