"""Configs of the port: the paper's dense models plus the test config.
Each module exposes ``CONFIG`` and ``REDUCED`` as in ``repro.configs``."""
from repro_torch.configs.base import (ControllerSettings, LayerSpec,
                                      ModelConfig, get_config)

__all__ = ["ControllerSettings", "LayerSpec", "ModelConfig", "get_config"]
