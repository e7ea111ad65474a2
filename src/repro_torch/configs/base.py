"""Model configuration dataclasses (the dense serving subset of
``repro.configs.base``, same field names and defaults)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional

__all__ = ["ModelConfig", "LayerSpec", "get_config"]


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


ARCHS = ["gpt2-125m", "llama-125m", "tiny"]


def get_config(arch: str) -> ModelConfig:
    """Load ``configs/<arch>.py`` and return its CONFIG."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
