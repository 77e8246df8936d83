"""A frozen copy of the Threefry-2x32 key stream, in plain PyTorch.

The benchmark's own copy of jax.random's partitionable threefry stream, so
the reference draws the owner schedule and the Laplace noise of a round
from the same keys as the program without importing it:

    key = prng_key(seed)                    # (2,) int64 words
    k_sched, k_round = split(key)
    owners = randint(k_sched, 8, 0, 16)     # jax.random.randint
    keys = split(k_round, 8)                # one key per round
    lap = laplace_rows(keys[0], 0, n)       # Laplace(bits) of counters [0, n)

Element i of bits(key, (n,)) is y0 ^ y1 of threefry2x32(key, (i >> 32,
i & 0xffffffff)); row i of split(key, n) is (y0, y1) of the same hash. Keys
are int64 tensors holding uint32 words, on any device.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# counters hashed per block by `laplace_rows`: bounds the int64 temporaries
BLOCK = 1 << 24


def _i32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> the same bits as int32."""
    words = words & MASK
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 bit patterns left by r (>> is arithmetic, so the bits
    brought in from the top are masked)."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32 on int64 tensors holding uint32 words, as
    int64 words. The rounds run on int32 bit patterns, whose additions
    wrap modulo 2**32 as uint32 ones do (two's complement)."""
    k0, k1, x0, x1 = (_i32(torch.as_tensor(v)) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0.to(torch.int64) & MASK, x1.to(torch.int64) & MASK


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words (seed >> 32, seed & 0xffffffff)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: (num, 2) int64 words."""
    k = key.to(torch.int64) & MASK
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a 32-bit int."""
    k = key.to(torch.int64) & MASK
    d = torch.tensor(int(data) & MASK, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1])


def bits(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Counters [start, stop) of bits(key, (n,)) for any n >= stop, as int64."""
    k = key.to(torch.int64) & MASK
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK)
    return y0 ^ y1


def randint(key: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """jax.random.randint(key, (n,), minval, maxval) as int64: two words
    per value from the halves of split(key), reduced mod the span with
    uint32 wrap-around."""
    span = maxval - minval
    if not 0 < span < 1 << 31:
        raise ValueError(f"randint needs 0 < maxval - minval < 2**31, got {span}")
    keys = split(key)
    hi = bits(keys[0], 0, n)
    lo = bits(keys[1], 0, n)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((hi % span) * mult) & MASK
    off = ((off + lo % span) & MASK) % span
    return off + minval


def laplace_from_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> standard Laplace draws: the top 24 bits as
    a uniform in [0, 1), centred, clipped to +-0.4999999, then -sign(v)
    log1p(-2|v|), all in f32 with sign(0) = 0."""
    u01 = (words >> 8).to(torch.float32) * (1.0 / (1 << 24))
    v = u01 - 0.5
    return -torch.sign(v) * torch.log1p(-2.0 * torch.abs(torch.clamp(v, -0.4999999, 0.4999999)))


def laplace_rows(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """laplace_from_bits(bits(key, start, stop)) in f32, hashed BLOCK
    counters at a time."""
    out = torch.empty(stop - start, dtype=torch.float32, device=key.device)
    for a in range(start, stop, BLOCK):
        b = min(a + BLOCK, stop)
        out[a - start:b - start] = laplace_from_bits(bits(key, a, b))
    return out
