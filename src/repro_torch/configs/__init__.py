"""Model configurations of the port."""
from repro_torch.configs.base import DENSE_124M, ModelConfig, SSMConfig
from repro_torch.configs.registry import get_config, list_archs

__all__ = ["DENSE_124M", "ModelConfig", "SSMConfig", "get_config", "list_archs"]
