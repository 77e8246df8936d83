"""Model configurations of the port."""
from repro_torch.configs.base import DENSE_124M, ModelConfig

__all__ = ["DENSE_124M", "ModelConfig"]
