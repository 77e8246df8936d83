"""Learning-rate schedules (step -> lr, a 0-d f32 tensor on the step's
device). Counterpart of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup: int):
    def f(step):
        return lr * torch.clamp(_f32(step) / max(warmup, 1), max=1.0)
    return f


def cosine_decay(lr: float, total: int, warmup: int = 0, floor: float = 0.0):
    def f(step):
        s = _f32(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0) if warmup else 1.0
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return w * (floor + (lr - floor) * cos)
    return f
