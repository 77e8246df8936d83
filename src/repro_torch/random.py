"""Threefry-2x32 key stream, bit-compatible with ``jax.random``.

The reference package draws every random number (owner schedules, round
keys, the Laplace bits of the DP response) from jax's threefry2x32 in its
partitionable mode (``jax_threefry_partitionable=True``, the jax 0.9
default). This module reproduces that stream exactly, so the port consumes
the reference's own keys and a whole trajectory can be held against it:

    key = PRNGKey(0)                 # (2,) uint32 tensor, on CUDA by default
    k1, k2 = split(key)              # rows of a (2, 2) tensor
    u = bits(k1, (5,))               # (5,) uint32 == jax.random.bits
    b = bits_block(k1, (4, 6), (2, 3), (2, 3))   # == bits(k1, (4, 6))[2:, 3:]
    i = randint(k2, (8,), 0, 4)      # (8,) int32  == jax.random.randint
    x = laplace(k2, (3, 4))          # (3, 4) f32  ~ jax.random.laplace (1 ulp)

Counter layout (partitionable mode): element ``i`` of ``bits(key, shape)``
is ``y0 ^ y1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``; row
``i`` of ``split(key, n)`` is ``(y0, y1)`` of the same hash; ``fold_in``
hashes the counter ``(0, data)``.

The float draws (`uniform`, `laplace`, `normal`) are jax's algorithms on
those bits: 23 random mantissa bits under the exponent of 1.0, minus 1,
scaled. `uniform` equals jax.random.uniform bit for bit; `laplace` and
`normal` go through log1p and erfinv, which torch and XLA compute with
other approximations (tests/test_torch_random.py states the tolerances).

`exponential` and `gumbel` are jax's formulas too, each log taken in f64
and rounded to f32 (jax rounds each log to f32): the draw is then the same
on every device, which the schedules' owner sequences rely on.

Keys are ``(2,)`` uint32 tensors on any device. Every function also takes a
batch of keys, a ``(..., 2)`` tensor, in place of ``vmap`` over keys: the
result gains the key's leading axes, and each key gives what it gives
alone (``split(keys, n)`` is ``(..., n, 2)``, ``bits(keys, shape)`` is
``(..., *shape)``; `fold_in` broadcasts its data against the key's leading
axes). torch's uint32 dtype lacks most arithmetic, so the hash runs on
int64 tensors masked to 32 bits; no intermediate exceeds 2**62, so nothing
overflows.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
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
    """The two key words of a (..., 2) key tensor, each (...,) int64."""
    if key.dim() == 0 or key.shape[-1] != 2:
        raise ValueError(f"a key is a (2,) tensor (or a (..., 2) batch), got shape "
                         f"{tuple(key.shape)}")
    k = key.to(torch.int64) & _MASK
    return k[..., 0], k[..., 1]


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
    """jax.random.split: (num, 2) uint32 keys ((..., num, 2) for a batch)."""
    k0, k1 = _words(key)
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    return _as_key(*threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1), torch.zeros_like(lo), lo))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: a (2,) key derived from `key` and a 32-bit int.
    `data` may be an int tensor; it broadcasts against the key's leading
    axes (fold_in(key, arange(T)) is the (T, 2) keys of T fold-ins)."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    return _as_key(*threefry2x32(k0, k1, torch.zeros_like(d), d))


def _block_counters(shape: Tuple[int, ...], offsets: Sequence[int],
                    local_shape: Sequence[int], device) -> torch.Tensor:
    """The flat (row-major) indices in a leaf of global `shape` of the
    block of `local_shape` at `offsets`, as a flat int64 tensor in the
    block's own row-major order."""
    offsets, local_shape = tuple(int(o) for o in offsets), tuple(int(n) for n in local_shape)
    if not len(shape) == len(offsets) == len(local_shape):
        raise ValueError(f"a block of {local_shape} at {offsets} does not match a leaf of "
                         f"shape {shape}")
    if any(o < 0 or o + n > d for o, n, d in zip(offsets, local_shape, shape)):
        raise ValueError(f"the block of {local_shape} at {offsets} leaves the leaf {shape}")
    idx = torch.zeros(local_shape, dtype=torch.int64, device=device)
    stride = 1
    for j in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[j] = local_shape[j]
        idx = idx + (torch.arange(offsets[j], offsets[j] + local_shape[j], dtype=torch.int64,
                                  device=device) * stride).reshape(view)
        stride *= shape[j]
    return idx.reshape(-1)


def _bits_i64(key: torch.Tensor, shape: Tuple[int, ...], start: int = 0,
              block: Optional[Tuple[Sequence[int], Sequence[int]]] = None) -> torch.Tensor:
    """The int64 words of bits(key, shape), from flat index `start` on; with
    `block` = (offsets, local_shape) only that block of the leaf (shaped
    local_shape)."""
    k0, k1 = _words(key)
    if block is None:
        idx = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                           device=key.device)
    else:
        idx = _block_counters(shape, block[0], block[1], key.device)
        shape = tuple(int(n) for n in block[1])
    y0, y1 = threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1), idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(tuple(k0.shape) + shape)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax.random.bits(key, shape) with the default uint32 width ((...,
    *shape) for a batch of keys)."""
    return _bits_i64(key, _shape(shape)).to(torch.uint32)


def bits_range(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Elements [start, stop) of a flat draw: bits(key, (n,))[start:stop] for
    any n >= stop, computed for the slice alone ((..., stop - start) for a
    batch of keys). A rank holding columns [start, stop) of a row draws
    the bits of those columns of the unsharded row."""
    if not 0 <= start <= stop:
        raise ValueError(f"bits_range needs 0 <= start <= stop, got [{start}, {stop})")
    return _bits_i64(key, (stop - start,), start).to(torch.uint32)


def bits_block(key: torch.Tensor, shape: Shape, offsets: Sequence[int],
               local_shape: Sequence[int]) -> torch.Tensor:
    """The block of `local_shape` at `offsets` of bits(key, shape), computed
    for the block alone ((..., *local_shape) for a batch of keys): each
    element hashes its global flat index. A rank holding a block of a leaf
    sharded on any of its dims draws the bits of that block of the
    unsharded leaf; `bits_range` is the 1-D case."""
    return _bits_i64(key, _shape(shape), block=(offsets, local_shape)).to(torch.uint32)


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
    hi = _bits_i64(keys[..., 0, :], shape)
    lo = _bits_i64(keys[..., 1, :], shape)
    # every product wraps at 32 bits as in jax's uint32 arithmetic; span <
    # 2**31 keeps the int64 products below 2**62
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((hi % span) * multiplier) & _MASK
    offset = ((offset + lo % span) & _MASK) % span
    return (offset + minval).to(torch.int32)


_ONE_BITS = 0x3F800000                  # the f32 bit pattern of 1.0
_F32_EPSNEG = 2.0 ** -24                # jnp.finfo(float32).epsneg


def uniform(key: torch.Tensor, shape: Shape = (), minval=0.0, maxval=1.0, *,
            block=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval).

    The top 23 bits of each word become the mantissa of a float in [1, 2);
    minus 1, times (maxval - minval), plus minval, then max(minval, .), all
    in f32 as jax computes them. `block` = (offsets, local_shape) draws
    only that block of the leaf, from the bits of `bits_block` (so for
    `laplace` and `normal` too)."""
    shape = _shape(shape)
    words = _bits_i64(key, shape, block=block)
    floats = ((words >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add. A
    # product of two f32 values is exact in f64, so one f64 multiply-add
    # rounded to f32 gives the fused result (up to a double rounding at an
    # exact f32 midpoint)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def laplace(key: torch.Tensor, shape: Shape = (), *, block=None) -> torch.Tensor:
    """jax.random.laplace(key, shape, float32): u uniform on
    [-1 + epsneg, 1), then sign(u) * log1p(-|u|)."""
    u = uniform(key, shape, -1.0 + _F32_EPSNEG, 1.0, block=block)
    return torch.sign(u) * torch.log1p(-torch.abs(u))


def normal(key: torch.Tensor, shape: Shape = (), *, block=None) -> torch.Tensor:
    """jax.random.normal(key, shape, float32): sqrt(2) * erfinv(u), u
    uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, block=block)
    return torch.erfinv(u) * float(np.float32(math.sqrt(2.0)))


_F32_TINY = float(np.finfo(np.float32).tiny)


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """jax.random.exponential(key, shape, float32): -log1p(-u), u uniform on
    [0, 1); the log1p in f64, rounded once to f32."""
    u = uniform(key, shape)
    return -torch.log1p(-u.double()).float()


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in its default mode "low":
    -log(-log(u)), u uniform on [tiny, 1); each log in f64, rounded to f32
    as jax rounds it."""
    u = uniform(key, shape, _F32_TINY, 1.0)
    inner = torch.log(u.double()).float()
    return -torch.log(-inner.double()).float()
