"""Models of the port (the dense and hybrid LM families so far)."""
from repro_torch.models.model import LM, build_model

__all__ = ["LM", "build_model"]
