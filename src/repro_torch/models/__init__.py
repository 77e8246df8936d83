"""Models of the port (the dense, moe, hybrid and ssm (xLSTM) LM families)."""
from repro_torch.models.model import LM, build_model

__all__ = ["LM", "build_model"]
