"""Owner schedules: who communicates at tick k.

Counterpart of the uniform half of ``repro/federation/schedules.py``.
`UniformSchedule` is line 3 of Algorithm 1 (i.i.d. uniform draws, the
distributional shortcut for symmetric rate-1 Poisson clocks) and draws
with ``random.randint``, so a key gives the reference's owner sequence
exactly. Draws stay on the key's device. Poisson and trace schedules wait
for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import resolve_device


class UniformSchedule:
    def draw(self, key: torch.Tensor, n_owners: int, horizon: int) -> torch.Tensor:
        """(horizon,) int32 owner sequence on the key's device."""
        return random.randint(key, (horizon,), 0, n_owners)


def as_owner_seq(seq, n_owners: int, device=None) -> torch.Tensor:
    """Normalize an owner sequence to the engines' (K,) int32 form on
    `device` (CUDA when None), validating its bounds once (one host copy
    of the sequence)."""
    seq = seq if isinstance(seq, torch.Tensor) else torch.tensor(np.asarray(seq))
    if seq.ndim != 1:
        raise ValueError(f"owner sequence must be 1-D, got {tuple(seq.shape)}")
    if seq.dtype.is_floating_point or seq.dtype == torch.bool:
        raise ValueError(f"owner sequence must be integer, got {seq.dtype}")
    if seq.numel():
        lo, hi = (int(v) for v in torch.aminmax(seq.cpu()))
        if lo < 0 or hi >= n_owners:
            raise ValueError(f"owner sequence out of range for {n_owners} owners")
    return seq.to(device=resolve_device(device), dtype=torch.int32)
