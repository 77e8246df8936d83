"""Poisson-clock owner scheduling (Section 3).

Counterpart of ``repro/federation/clocks.py``. Each owner carries an
independent rate-1 Poisson point process; whenever a clock ticks, that
owner communicates with the learner. Symmetric rates make the
communicating-owner sequence i_k i.i.d. uniform over owners, which is
exactly line 3 of Algorithm 1. Both the continuous-time simulation and the
uniform shortcut are here; the session-level schedules are in
``schedules.py``.

Every draw takes a (2,) key or a (..., 2) batch of keys (``random``'s
batched form, for replicas) and stays on the key's device. The owner
sequences equal the reference's for the same key; the times are jax's
exponential gaps, cumulated in the order jax's cumsum takes on the CPU, so
the same key gives the same times on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random

_SCAN_BASE = 16


class Schedule(NamedTuple):
    times: torch.Tensor   # (..., T) f32: communication instants t_k
    owners: torch.Tensor  # (..., T) int32: communicating owner i_k


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumulative sum along the last axis, in the order jax's
    ``cumsum`` takes on the CPU (XLA rewrites it into a scan of base 16:
    running sums within blocks of 16, the blocks' totals scanned the same
    way, each block's prefix added to its running sums). Plain f32 adds,
    so every device gives the same bits."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        out = x.clone()
        for j in range(1, n):
            out[..., j] += out[..., j - 1]
        return out
    m = -(-n // _SCAN_BASE)
    pad = x.new_zeros(x.shape[:-1] + (m * _SCAN_BASE - n,))
    inner = _cumsum(torch.cat([x, pad], -1).reshape(x.shape[:-1] + (m, _SCAN_BASE)))
    prefix = _cumsum(inner[..., -1])
    excl = torch.cat([prefix.new_zeros(prefix.shape[:-1] + (1,)), prefix[..., :-1]], -1)
    return (inner + excl.unsqueeze(-1)).reshape(x.shape[:-1] + (m * _SCAN_BASE,))[..., :n]


def poisson_schedule(key: torch.Tensor, n_owners: int, horizon: int, rate: float = 1.0
                     ) -> Schedule:
    """Continuous-time simulation: superpose N rate-`rate` processes.

    The superposition is a rate-(N*rate) Poisson process whose marks are
    i.i.d. uniform; the inter-arrival gaps and marks are drawn directly."""
    ks = random.split(key)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    total_rate = torch.full((), n_owners * rate, dtype=torch.float32, device=key.device)
    gaps = random.exponential(k1, (horizon,)) / total_rate
    owners = random.randint(k2, (horizon,), 0, n_owners)
    return Schedule(_cumsum(gaps), owners)


def uniform_schedule(key: torch.Tensor, n_owners: int, horizon: int) -> torch.Tensor:
    """The i.i.d.-uniform i_k sequence (equivalent in distribution)."""
    return random.randint(key, (horizon,), 0, n_owners)


def owner_counts(owners: torch.Tensor, n_owners: int) -> torch.Tensor:
    """Responses per owner of a (T,) owner sequence (ids past n_owners are
    dropped, as jnp.bincount(length=n_owners) drops them)."""
    return torch.bincount(owners.to(torch.int64), minlength=n_owners)[:n_owners]
