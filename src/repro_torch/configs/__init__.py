"""Configs of the port: the paper's dense models, the MoE models and the
test config.
Each module exposes ``CONFIG`` and ``REDUCED`` as in ``repro.configs``."""
from repro_torch.configs.base import (ControllerSettings, LayerSpec,
                                      ModelConfig, MoESettings, get_config)

__all__ = ["ControllerSettings", "LayerSpec", "ModelConfig", "MoESettings",
           "get_config"]
