"""Gradient privatization config (Xi enforced by clipping).

Counterpart of ``repro/federation/dp_sgd.py``. Assumption 2 (bounded
per-record gradient) does not hold for transformers; it is enforced by
clipping before averaging. The port runs the 'microbatch' granularity:
each group gradient is clipped to xi and the groups are averaged (the DP
adjacency unit is a group). With ``fused_kernel=True`` the clip norm and
the whole post-gradient round run through the dp_clip_noise kernels; the
jnp-equivalent reference mode, 'example' granularity and `private_grad`
for pytree states wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class PrivatizerConfig:
    xi: float                        # clip norm (== Assumption-2 bound)
    granularity: str = "microbatch"  # the port runs 'microbatch'
    n_microbatches: int = 8
    mechanism: str = "laplace"
    # route the clip norm and the mean + Laplace add + inertia updates
    # through the dp_clip_noise kernels (the only mode the port runs)
    fused_kernel: bool = False


def _group_batch(batch: Dict[str, torch.Tensor], n_groups: int) -> Dict[str, torch.Tensor]:
    """Reshape every leaf (B, ...) -> (G, B/G, ...)."""
    return {k: a.reshape((n_groups, a.shape[0] // n_groups) + tuple(a.shape[1:]))
            for k, a in batch.items()}
