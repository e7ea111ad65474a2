"""Configs of the port: the paper's dense models plus the test config.
Each module exposes ``CONFIG`` and ``REDUCED`` as in ``repro.configs``."""
from repro_torch.configs.base import LayerSpec, ModelConfig, get_config

__all__ = ["LayerSpec", "ModelConfig", "get_config"]
