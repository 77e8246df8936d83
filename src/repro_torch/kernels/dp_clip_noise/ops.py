"""Entry points of the dp_clip_noise kernels for the flat round engine.

The counterpart of ``repro/kernels/dp_clip_noise/ops.py`` (its
``dp_round_flat`` and ``fused_sqnorm_tree``). The backend follows the
tensor: a CPU tensor runs the plain version from ``ref.py``; a CUDA tensor
launches the kernel from ``kernel.py``, and a failed build or launch
raises. There is no fallback from one to the other.

The Laplace bits are the round key's ``random.bits(key, (P,))`` stream on
both backends: the plain version draws them, the kernel hashes each
element's index in-kernel. Both therefore see the noise the reference's
off-TPU path draws (``dp_round_flat(..., interpret="oracle")``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import random
from repro_torch.kernels.dp_clip_noise.kernel import dp_round_cuda, sqnorm_cuda
from repro_torch.kernels.dp_clip_noise.ref import dp_round_ref, sqnorm_ref


def _unsupported(t: torch.Tensor, op: str) -> ValueError:
    return ValueError(f"{op}: tensors on {t.device} are not supported "
                      "(cpu runs the plain version, cuda the kernel)")


def dp_round_flat(tb: torch.Tensor, acc: torch.Tensor, key: torch.Tensor,
                  gain, noise_scale, w, *, sigma: float, lr_own: float,
                  lr_l: float, n_owners: int, theta_max: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole inertia round on a (P,) f32 buffer -> (new_L, new_i): group
    mean (`gain`), the Laplace add (eq. 4), eqs. (5)/(7) and the theta_max
    projection in one pass. On CUDA, `gain`, `noise_scale` and `w` are
    one-element device tensors."""
    if tb.device.type == "cpu":
        return dp_round_ref(tb, acc, random.bits(key, tb.shape), gain, noise_scale,
                            w, sigma=sigma, lr_own=lr_own, lr_l=lr_l,
                            n_owners=n_owners, theta_max=theta_max)
    if tb.device.type == "cuda":
        return dp_round_cuda(tb, acc, key, gain, noise_scale, w, sigma=sigma,
                             lr_own=lr_own, lr_l=lr_l, inv_2n=1.0 / (2 * n_owners),
                             theta_max=theta_max)
    raise _unsupported(tb, "dp_round_flat")


def fused_sqnorm(g: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm of a flat f32 gradient as a 0-d tensor (the clip
    norm of one microbatch, before the square root)."""
    if g.device.type == "cpu":
        return sqnorm_ref(g)
    if g.device.type == "cuda":
        return sqnorm_cuda(g)
    raise _unsupported(g, "fused_sqnorm")
