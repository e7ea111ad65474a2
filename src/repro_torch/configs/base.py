"""Model and training configuration dataclasses (the dense subset of
``repro.configs.base``, same field names and defaults)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple

__all__ = ["ModelConfig", "LayerSpec", "ControllerSettings",
           "TrainConfig", "get_config"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # 'attn' | 'mamba'
    cross: bool = False        # extra cross-attention sublayer
    ffn: str = "dense"         # 'dense' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field-for-field the reference ``ModelConfig``, so one config dict
    round-trips between the packages.  The port runs the dense family;
    ``moe``/``mamba`` stay ``None``.

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
    moe: Optional[object] = None
    mamba: Optional[object] = None
    attn_layer_period: int = 0
    cross_attn_period: int = 0
    n_encoder_layers: int = 0
    n_frames: int = 1500
    n_patches: int = 1601
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
        if self.family != "dense":
            raise NotImplementedError(
                f"repro_torch runs the dense family; got {self.family!r}")
        return [LayerSpec() for _ in range(self.n_layers)]

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
    ``Trainer`` runs one device with AdamW or Adafactor, the plan presets
    (``plan_preset``, ``plan_k``, ``plan_frac``), the §3.3 switch,
    checkpoints and resume (``checkpoint_every``, ``checkpoint_dir``,
    ``keep_checkpoints``, ``async_checkpoint``), quantization telemetry
    (``telemetry``, ``telemetry_every``, ``telemetry_jsonl``), the step
    timer (``profiler_warmup``), the adaptive precision controller
    (``controller``, a ``ControllerSettings``) and its measured cost
    calibration (``cost_calibration``, a ``speed_factors.v1`` JSON path);
    it raises ``NotImplementedError`` for the fields of the features it
    does not have yet (fp8 gradient compression, meshes) rather than
    ignore them."""

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


ARCHS = ["gpt2-125m", "gpt2-335m", "gpt2-774m", "h2o-danube-3-4b",
         "llama-125m", "llama-1b", "tiny"]


def get_config(arch: str) -> ModelConfig:
    """Load ``configs/<arch>.py`` and return its CONFIG."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
