"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).
Counterpart of ``repro/models/mlp.py``.

The GELU is the tanh form: the reference's `jax.nn.gelu` defaults to
approximate=True, torch's `F.gelu` to the exact erf form, which differs
from it by up to 4.7e-4."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding.spmd import einsum


class MLPParams(NamedTuple):
    w_gate: Optional[torch.Tensor]   # (d, f) — None for the plain GELU MLP
    w_up: torch.Tensor               # (d, f)
    w_down: torch.Tensor             # (f, d)


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> MLPParams:
    return MLPParams(dense_init((d_model, d_ff), generator, dtype),
                     dense_init((d_model, d_ff), generator, dtype),
                     dense_init((d_ff, d_model), generator, dtype))


def init_gelu(generator: torch.Generator, d_model: int, d_ff: int,
              dtype=torch.float32) -> MLPParams:
    return MLPParams(None, dense_init((d_model, d_ff), generator, dtype),
                     dense_init((d_ff, d_model), generator, dtype))


def mlp_forward(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    up = einsum("bsd,df->bsf", x, p.w_up)
    if p.w_gate is None:
        h = F.gelu(up, approximate="tanh")
    else:
        h = F.silu(einsum("bsd,df->bsf", x, p.w_gate)) * up
    return einsum("bsf,fd->bsd", h, p.w_down)
