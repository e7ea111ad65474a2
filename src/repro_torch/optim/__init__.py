"""Optimizers with f32 master weights, the LR schedule, gradient
clipping and fp8 gradient compression (counterpart of ``repro.optim``)."""
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compression import (compressed_psum,
                                           compressed_psum_grads,
                                           compressed_reduce_dp,
                                           fp8_compress_grads,
                                           init_compression_state)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["Optimizer", "adamw", "adafactor", "warmup_cosine",
           "clip_by_global_norm", "global_norm", "fp8_compress_grads",
           "init_compression_state", "compressed_psum",
           "compressed_psum_grads", "compressed_reduce_dp", "get_optimizer"]


def get_optimizer(name: str, **kw) -> Optimizer:
    """The optimizer a ``ModelConfig.optimizer`` names."""
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":     # no momentum: AdamW's betas and eps go
        kw = {k: v for k, v in kw.items()
              if k not in ("beta1", "beta2", "eps")}
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
