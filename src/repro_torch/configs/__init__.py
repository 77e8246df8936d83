"""Model and input-shape configurations of the port."""
from repro_torch.configs.base import (DENSE_124M, INPUT_SHAPES, ModelConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, XLSTMConfig)
from repro_torch.configs.registry import all_configs, get_config, get_shape, list_archs

__all__ = [
    "DENSE_124M",
    "INPUT_SHAPES",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "XLSTMConfig",
    "all_configs",
    "get_config",
    "get_shape",
    "list_archs",
]
