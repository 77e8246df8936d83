"""Threefry-2x32 key stream, bit-compatible with ``jax.random``.

The reference package draws every random number (owner schedules, round
keys, the Laplace bits of the DP response) from jax's threefry2x32 in its
partitionable mode (``jax_threefry_partitionable=True``, the jax 0.9
default). This module reproduces that stream exactly, so the port consumes
the reference's own keys and a whole trajectory can be held against it:

    key = PRNGKey(0)                 # (2,) uint32 tensor, on CUDA by default
    k1, k2 = split(key)              # rows of a (2, 2) tensor
    u = bits(k1, (5,))               # (5,) uint32 == jax.random.bits
    i = randint(k2, (8,), 0, 4)      # (8,) int32  == jax.random.randint

Counter layout (partitionable mode): element ``i`` of ``bits(key, shape)``
is ``y0 ^ y1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``; row
``i`` of ``split(key, n)`` is ``(y0, y1)`` of the same hash; ``fold_in``
hashes the counter ``(0, data)``.

Keys are ``(2,)`` uint32 tensors on any device. torch's uint32 dtype lacks
most arithmetic, so the hash runs on int64 tensors masked to 32 bits; no
intermediate exceeds 2**62, so nothing overflows.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(d) for d in shape)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32
    values; arguments broadcast. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key: torch.Tensor):
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor, got shape {tuple(key.shape)}")
    k = key.to(torch.int64) & _MASK
    return k[0], k[1]


def _as_key(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    return torch.stack([y0, y1], dim=-1).to(torch.uint32)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a non-negative integer seed, on
    `device` (CUDA when None)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=resolve_device(device)).to(torch.uint32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: (num, 2) uint32 keys."""
    k0, k1 = _words(key)
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    return _as_key(*threefry2x32(k0, k1, torch.zeros_like(lo), lo))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: a (2,) key derived from `key` and a 32-bit int."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    return _as_key(*threefry2x32(k0, k1, torch.zeros_like(d), d))


def _bits_i64(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    k0, k1 = _words(key)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(shape)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax.random.bits(key, shape) with the default uint32 width."""
    return _bits_i64(key, _shape(shape)).to(torch.uint32)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) for int32 output.

    jax's two-draw modular algorithm: 64 random bits per value (two
    independent uint32 words from the two halves of split(key)) reduced
    mod the span with uint32 wrap-around arithmetic."""
    minval, maxval = int(minval), int(maxval)
    if not (-(1 << 31) <= minval < maxval <= (1 << 31) - 1
            and maxval - minval < 1 << 31):
        raise ValueError(f"randint needs int32 bounds with 0 < maxval - minval "
                         f"< 2**31, got [{minval}, {maxval})")
    shape = _shape(shape)
    span = maxval - minval
    keys = split(key)
    hi = _bits_i64(keys[0], shape)
    lo = _bits_i64(keys[1], shape)
    # every product wraps at 32 bits as in jax's uint32 arithmetic; span <
    # 2**31 keeps the int64 products below 2**62
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((hi % span) * multiplier) & _MASK
    offset = ((offset + lo % span) & _MASK) % span
    return (offset + minval).to(torch.int32)
