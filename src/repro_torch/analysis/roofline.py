"""Three-term roofline on the H100 (counterpart of
``repro.analysis.roofline``, whose machine entry is a TPU's):

    compute term    = flops       / (chips * peak_flops)
    memory term     = bytes       / (chips * hbm_bw)
    collective term = coll_bytes  / (chips * link_bw)

All terms are per-chip seconds.  ``model_flops`` (6 N D for training,
2 N per token otherwise) and ``scan_flop_corrections`` (the flops the
reference's cost analysis misses inside interior scans: the attention
KV-chunk scan, the seq-chunked LM-head loss, the Mamba inter-chunk
state scan) are the reference's formulas, so they give the same numbers
for the same config and cell.  ``HW_H100`` is the card the port runs
on; the other terms' inputs come from the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeCell

__all__ = ["HW", "HW_H100", "roofline_terms", "model_flops",
           "scan_flop_corrections"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float      # bf16 FLOP/s per chip
    hbm_bw: float          # bytes/s per chip
    link_bw: float         # interconnect bytes/s per chip (per-link figure)


# NVIDIA H100 SXM5 80 GB at its 700 W limit: 989 TFLOP/s dense bf16 and
# 3.35 TB/s HBM3 from the data sheet (the figures chip_smoke.py's bounds
# use); link: one NVLink 4 link as `nvidia-smi nvlink --status` reads it
# on the card, 26.562 GB/s (the card has 18).
HW_H100 = HW("nvidia_h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
             link_bw=26.562e9)


def model_flops(cfg: ModelConfig, cell: ShapeCell, n_active: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N per token of a prefill, 2*N
    per generated token for decode (N = active params; D = tokens)."""
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def _attention_flops(cfg: ModelConfig, bsz: int, sq: int, skv: int) -> float:
    """Flops of one attention layer's forward (scores, context, softmax)
    over the full rectangle (no causal block skipping)."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    mm = 2 * 2 * bsz * h * sq * skv * hd
    soft = 5 * bsz * h * sq * skv
    return mm + soft


def scan_flop_corrections(cfg: ModelConfig, cell: ShapeCell,
                          chips: int) -> Dict[str, float]:
    """Per-chip flops an interior scan hides from a cost analysis that
    counts a loop body once: ``{'attn', 'head', 'ssd', 'total'}``."""
    train = cell.kind == "train"
    factor = 4.0 if train else 1.0     # fwd + remat + bwd(2x)  vs  fwd
    bsz = cell.global_batch
    sq = cell.seq_len if cell.kind != "decode" else 1
    skv = cell.seq_len
    if cell.kind == "decode" and cfg.sliding_window:
        skv = min(skv, cfg.sliding_window)   # ring-buffer cache

    specs = cfg.layer_specs()
    n_attn = sum(1 for s in specs if s.mixer == "attn")
    n_cross = sum(1 for s in specs if s.cross)
    n_mamba = sum(1 for s in specs if s.mixer == "mamba")

    out = {"attn": 0.0, "head": 0.0, "ssd": 0.0}

    # attention KV-chunk scan
    chunk = min(cfg.attention_chunk, skv)
    n_chunks = max(skv // chunk, 1)
    if n_chunks > 1 and not cfg.unroll_attention:
        per_layer = _attention_flops(cfg, bsz, sq, skv)
        out["attn"] += (n_attn * factor * per_layer
                        * (n_chunks - 1) / n_chunks)
    # cross-attention scan (kv = patches / frames)
    skv_cross = cfg.n_patches if cfg.family == "vlm" else cfg.n_frames
    cch = min(cfg.attention_chunk, skv_cross)
    ncc = max(skv_cross // cch, 1)
    if n_cross and ncc > 1 and not cfg.unroll_attention:
        per_layer = _attention_flops(cfg, bsz, sq, skv_cross)
        out["attn"] += n_cross * factor * per_layer * (ncc - 1) / ncc

    # seq-chunked LM head (train only; serving heads the last position)
    if train and cfg.loss_chunk and cfg.loss_chunk < cell.seq_len:
        n = cell.seq_len // cfg.loss_chunk
        head = 2.0 * bsz * cell.seq_len * cfg.d_model * cfg.vocab_size
        out["head"] += factor * head * (n - 1) / n

    # mamba inter-chunk state scan
    if n_mamba and cfg.mamba is not None and cell.kind != "decode":
        st = cfg.mamba
        d_inner = st.expand * cfg.d_model
        nheads = d_inner // st.headdim
        nc = max(sq // st.chunk, 1)
        per_chunk = 3.0 * bsz * nheads * st.headdim * st.d_state
        out["ssd"] += n_mamba * factor * per_chunk * max(nc - 1, 0)

    total = sum(out.values())
    out = {k: v / chips for k, v in out.items()}
    out["total"] = total / chips
    return out


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   collective_bytes_eff: float, chips: int,
                   flop_correction: float = 0.0,
                   hw: HW = HW_H100,
                   model_flops_total: Optional[float] = None
                   ) -> Dict[str, float]:
    """The three terms, the bottleneck and the step-time lower bound.
    Every input is per chip except ``model_flops_total`` (global); the
    argument names are the reference's (``hlo_flops``: the step's
    counted flops, ``hlo_bytes``: its bytes)."""
    flops = hlo_flops + flop_correction
    compute_s = flops / hw.peak_flops
    memory_s = hlo_bytes / hw.hbm_bw
    collective_s = collective_bytes_eff / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "hlo_flops_per_chip": flops,
             "hlo_flops_raw": hlo_flops,
             "flop_correction": flop_correction,
             "hlo_bytes_per_chip": hlo_bytes,
             "collective_bytes_eff": collective_bytes_eff,
             "chips": chips}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    bound = max(compute_s, memory_s, collective_s)
    terms["step_time_lower_bound_s"] = bound
    if model_flops_total is not None:
        terms["model_flops_total"] = model_flops_total
        terms["useful_flops_ratio"] = (
            model_flops_total / max(flops * chips, 1.0))
        # MFU at the roofline bound: useful flops / (chips*peak*bound)
        terms["mfu_at_bound"] = (model_flops_total
                                 / max(chips * hw.peak_flops * bound, 1e-30))
    return terms
