"""Step bodies. Counterpart of ``repro/launch/steps.py``.

`prefill_logits` is the body of the reference's prefill step
(`build_prefill_step`): the forward, then the last position against the
unembedding. The reference's meshes and sharding specs wait for the
port's sharding (ROADMAP item 13); here the step runs on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import LM, Batch, Params


def prefill_logits(model: LM, params: Params, batch: Batch,
                   window: Optional[int] = None) -> torch.Tensor:
    """Logits (B, V) of the last position of `batch["tokens"]` (B, S)."""
    x = model.forward(params, batch, window=window)
    return torch.einsum("bd,dv->bv", x[:, -1], model._unembed(params))
