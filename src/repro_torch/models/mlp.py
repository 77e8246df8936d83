"""Feed-forward block: SwiGLU. Counterpart of ``repro/models/mlp.py``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


class MLPParams(NamedTuple):
    w_gate: Optional[torch.Tensor]   # (d, f)
    w_up: torch.Tensor               # (d, f)
    w_down: torch.Tensor             # (f, d)


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> MLPParams:
    return MLPParams(dense_init((d_model, d_ff), generator, dtype),
                     dense_init((d_model, d_ff), generator, dtype),
                     dense_init((d_ff, d_model), generator, dtype))


def mlp_forward(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    up = torch.einsum("bsd,df->bsf", x, p.w_up)
    if p.w_gate is None:
        raise NotImplementedError("the GELU MLP waits for a later slice")
    gate = torch.einsum("bsd,df->bsf", x, p.w_gate)
    return torch.einsum("bsf,fd->bsd", F.silu(gate) * up, p.w_down)
