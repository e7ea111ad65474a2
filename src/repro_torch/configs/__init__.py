"""Configs of the port: the paper's dense models, the assigned dense,
MoE, SSM, hybrid, vision-language and audio models and the test config.
Each module exposes ``CONFIG`` and ``REDUCED`` as in ``repro.configs``."""
from repro_torch.configs.base import (ControllerSettings, LayerSpec,
                                      MambaSettings, ModelConfig,
                                      MoESettings, get_config)

__all__ = ["ControllerSettings", "LayerSpec", "MambaSettings",
           "ModelConfig", "MoESettings", "get_config"]
