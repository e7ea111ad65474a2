"""Model and training configuration dataclasses (the dense subset of
``repro.configs.base``, same field names and defaults)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple

__all__ = ["ModelConfig", "LayerSpec", "TrainConfig", "get_config"]


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
class TrainConfig:
    """Field-for-field the reference ``TrainConfig``.  The port's
    ``Trainer`` runs one device with AdamW or Adafactor, the plan presets
    (``plan_preset``, ``plan_k``, ``plan_frac``), the §3.3 switch,
    checkpoints and resume (``checkpoint_every``, ``checkpoint_dir``,
    ``keep_checkpoints``, ``async_checkpoint``), quantization telemetry
    (``telemetry``, ``telemetry_every``, ``telemetry_jsonl``) and the step
    timer (``profiler_warmup``); it raises ``NotImplementedError`` for
    every field of a feature it does not have yet (the controller, fp8
    gradient compression, meshes, cost calibration) rather than ignore
    it."""

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
    controller: Optional[object] = None
    plan_preset: str = "uniform"
    plan_k: int = 2
    plan_frac: float = 0.5
    profiler_warmup: int = 2
    cost_calibration: str = ""


ARCHS = ["gpt2-125m", "gpt2-335m", "gpt2-774m", "llama-125m", "llama-1b",
         "tiny"]


def get_config(arch: str) -> ModelConfig:
    """Load ``configs/<arch>.py`` and return its CONFIG."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
