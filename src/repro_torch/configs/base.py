"""Model and training configuration dataclasses (counterpart of
``repro.configs.base``, same field names and defaults)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple

__all__ = ["ModelConfig", "MoESettings", "MambaSettings", "LayerSpec",
           "ControllerSettings", "TrainConfig", "ShapeCell", "SHAPE_CELLS",
           "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class MoESettings:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 2048      # router group size (GShard-style)
    every_k_layers: int = 1     # MoE FFN on layers with i % k == k-1
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MambaSettings:
    d_state: int = 128
    d_conv: int = 4
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # 'attn' | 'mamba'
    cross: bool = False        # extra cross-attention sublayer
    ffn: str = "dense"         # 'dense' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field-for-field the reference ``ModelConfig``, so one config dict
    round-trips between the packages.  The port runs every family: dense,
    MoE (``moe``, a ``MoESettings``), SSM and hybrid (``mamba``, a
    ``MambaSettings``), and the cross-attention families vlm
    (``cross_attn_period``, ``n_patches``) and audio
    (``n_encoder_layers``, ``n_frames``).

    ``linear_impl``: ``"qdq"`` (unfused QDQ simulation), ``"pallas"`` (the
    fused quantize+matmul kernels; in this package the hand-written CUDA
    kernels of ``kernels/csrc``) or ``"pallas_two_pass"`` (the same,
    pinned to the quantize-pass + matmul-pass pipeline).
    """

    name: str
    family: str                # dense|moe|vlm|audio|ssm|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    activation: str = "swiglu"  # gelu|swiglu|relu2
    norm: str = "rmsnorm"      # layernorm|rmsnorm
    pos_emb: str = "rope"      # rope|learned|none
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    sliding_window: int = 0    # 0 = full attention
    tie_embeddings: bool = False
    qkv_bias: bool = False
    moe: Optional[MoESettings] = None
    mamba: Optional[MambaSettings] = None
    attn_layer_period: int = 0   # hybrid: attention at i % p == p//2
    cross_attn_period: int = 0   # vlm: cross sublayer at i % p == p-2
    n_encoder_layers: int = 0    # audio enc-dec
    n_frames: int = 1500         # audio frontend stub
    n_patches: int = 1601        # vlm frontend stub
    dtype: str = "bfloat16"
    attention_impl: str = "chunked"
    linear_impl: str = "qdq"
    attention_chunk: int = 1024
    kv_cache_format: Optional[str] = None
    scan_layers: bool = True
    unroll_attention: bool = False
    remat: bool = True
    remat_policy: str = "full"
    z_loss: float = 0.0
    loss_chunk: int = 0
    optimizer: str = "adamw"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_specs(self) -> List[LayerSpec]:
        """One spec a layer, as the reference's: an ssm stack is mamba
        mixers with no FFN; otherwise attention, or (``attn_layer_period``
        p, the hybrid) mamba except at ``i % p == p // 2``; a cross
        sublayer where ``i % cross_attn_period == cross_attn_period - 2``
        (the reference's rule verbatim: with a period of 1, whisper's, no
        layer has one); the FFN dense or MoE on the layers with
        ``i % every_k_layers == k - 1``."""
        specs = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                specs.append(LayerSpec("mamba", False, "none"))
                continue
            mixer = "attn"
            if self.attn_layer_period:
                p = self.attn_layer_period
                mixer = "attn" if i % p == p // 2 else "mamba"
            cross = bool(self.cross_attn_period
                         and i % self.cross_attn_period
                         == self.cross_attn_period - 2)
            ffn = "dense"
            if self.moe is not None:
                k = self.moe.every_k_layers
                ffn = "moe" if i % k == k - 1 else "dense"
            specs.append(LayerSpec(mixer, cross, ffn))
        return specs

    def scan_period(self) -> int:
        """Smallest repeating period of layer_specs (scan group size)."""
        specs = self.layer_specs()
        n = len(specs)
        for p in range(1, n + 1):
            if n % p == 0 and all(specs[i] == specs[i % p]
                                  for i in range(n)):
                return p
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ControllerSettings:
    """Adaptive-precision controller thresholds (telemetry.controller).

    All decision rules are opt-in: a threshold of 0.0 disables that rule, so
    the default ``ControllerSettings()`` reproduces the static §3.3 schedule.
    """

    # Dynamic target-precision switch: switch to the stage-2 recipe when the
    # EMA of the forward quant relative error crosses this value (OR at the
    # schedule's fixed fraction, whichever comes first).  0 = fraction only.
    switch_error_threshold: float = 0.0
    error_ema_decay: float = 0.9
    # Per-(layer, class) demotion: sustained overflow (clip rate) above the
    # threshold for ``demote_patience`` consecutive steps promotes that one
    # plan cell to FP8 (a ``PrecisionPlan.promote`` transform — one noisy
    # layer no longer demotes the whole class).  0 = disabled.
    demote_overflow_threshold: float = 0.0
    demote_patience: int = 8
    # Loss-spike rollback: loss > spike_factor * EMA(loss) triggers a restore
    # of the last checkpoint + ``replay_steps`` steps at the target (high)
    # precision before FP4 resumes.  0 = disabled.
    spike_factor: float = 0.0
    loss_ema_decay: float = 0.9
    spike_warmup: int = 20       # steps of EMA warmup before spikes arm
    replay_steps: int = 5
    max_rollbacks: int = 2
    # Controller-driven LR backoff: each rollback multiplies the LR scale by
    # ``lr_backoff`` (e.g. 0.5); the scale then recovers geometrically to
    # 1.0 over ~``lr_recovery_steps`` clean steps.  The scale is a traced
    # scalar input of the step graph (no recompile) and persists in the
    # controller's checkpoint state.  0 = disabled.
    lr_backoff: float = 0.0
    lr_recovery_steps: int = 50
    # Telemetry-driven plan search (telemetry.controller.PlanSearcher):
    # every ``plan_search_every`` steps the searcher finalizes a measured
    # (cost, quant-error) frontier point for the running plan and applies
    # one greedy edit — promote the worst-error (layer, class) cell to FP8,
    # or, when the cost budget is exhausted, demote the healthiest cell's
    # wgrad roles to FP4 (``PrecisionPlan.demote``, the asymmetric
    # role-subset transform; dgrad is never demoted).  Search runs in
    # stage 1 only and its state (per-cell error EMAs, applied edits,
    # frontier) persists in the controller checkpoint state, so resume is
    # bit-exact.  Requires ``TrainConfig.telemetry``.
    plan_search: bool = False
    plan_search_every: int = 10       # steps between search moves
    plan_search_cost_budget: float = 0.0   # max plan_cost (1.0 = BF16
    #                                        baseline); 0 = unbounded
    plan_search_max_edits: int = 8    # total edits before the search stops
    plan_search_demote_threshold: float = 0.0  # demote cells whose error
    #                                    EMA is below this; 0 = never demote


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field-for-field the reference ``TrainConfig``.  The port's
    ``Trainer`` runs AdamW or Adafactor, the plan presets
    (``plan_preset``, ``plan_k``, ``plan_frac``), the §3.3 switch,
    checkpoints and resume (``checkpoint_every``, ``checkpoint_dir``,
    ``keep_checkpoints``, ``async_checkpoint``), quantization telemetry
    (``telemetry``, ``telemetry_every``, ``telemetry_jsonl``), the step
    timer (``profiler_warmup``), the adaptive precision controller
    (``controller``, a ``ControllerSettings``) and its measured cost
    calibration (``cost_calibration``, a ``speed_factors.v1`` JSON path),
    fp8 error-feedback gradient compression (``grad_compression``) and
    data-parallel meshes (``mesh_shape``, ``mesh_axes``, ``fsdp``; a
    model axis larger than 1 raises ``NotImplementedError``)."""

    recipe: str = "paper_fp4"
    total_steps: int = 200
    global_batch: int = 8
    seq_len: int = 512
    microbatch: int = 0          # 0 = no gradient accumulation
    learning_rate: float = 6e-4
    warmup_frac: float = 0.0015
    min_lr_frac: float = 0.1
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 0    # 0 = disabled
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    async_checkpoint: bool = False
    grad_compression: str = "none"   # none | fp8 (error-feedback)
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    fsdp: bool = True
    log_every: int = 10
    telemetry: bool = False
    telemetry_every: int = 1
    telemetry_jsonl: str = ""
    target_recipe: str = "bf16"      # stage-2 recipe of the §3.3 schedule
    controller: Optional[ControllerSettings] = None  # adaptive controller
    plan_preset: str = "uniform"
    plan_k: int = 2
    plan_frac: float = 0.5
    profiler_warmup: int = 2
    cost_calibration: str = ""


# ---------------------------------------------------------------------------
# Assigned input-shape cells (LM-family: seq_len x global_batch), the
# reference's, same fields, cells and order.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

ARCHS = [
    "nemotron-4-15b", "llama3.2-3b", "h2o-danube-3-4b", "granite-34b",
    "mixtral-8x22b", "olmoe-1b-7b", "llama-3.2-vision-90b", "whisper-base",
    "mamba2-780m", "jamba-1.5-large-398b",
    # the paper's own configs
    "gpt2-125m", "gpt2-335m", "gpt2-774m", "llama-125m", "llama-1b",
    # test config
    "tiny",
]


def get_config(arch: str) -> ModelConfig:
    """Load ``configs/<arch>.py`` and return its CONFIG."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(ARCHS)
