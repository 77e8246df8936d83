"""Plain PyTorch versions of the bank_codec kernels.

The counterpart of ``repro/kernels/bank_codec/ref.py``, op for op. Two row
codecs for the (N_owners, P) owner bank:

  int8 — symmetric linear code: q = clip(floor(x/scale + u), -127, 127),
    decode q * scale. floor(v + u) with u ~ U[0, 1) is stochastic
    rounding; u = 0.5 is the deterministic round-to-nearest of bank init.
  fp8 — float8_e4m3fn, stochastically rounded ON THE fp8 GRID between the
    two neighbouring bit patterns of |x|/scale; codes are the raw uint8 bit
    patterns (sign in the top bit), never a float8 tensor.

Both encoders return err = x - decode(encode(x)) in f32, the error-feedback
residual. The wrappers in ``ops.py`` run these on CPU tensors (the CPU
tests), and the chip smoke script holds each CUDA kernel against them on
the card; nothing on the main path with a card calls them.

Every division divides by a tensor: torch turns a division by a Python
float into a reciprocal multiply on CUDA, which rounds differently from
the kernel's (and the reference's) IEEE division. The uint32 arithmetic
of the counter hash runs on int64 tensors masked to 32 bits, as
``repro_torch/random.py`` does, since torch's uint32 lacks most ops.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import random

INT8_QMAX = 127.0
FP8_QMAX = 448.0          # largest finite float8_e4m3fn
_TINY = 1e-30             # scale floor: an all-zero row decodes to zeros
_MASK = 0xFFFFFFFF
# The rounding seed comes from the round key folded with a fixed salt, so
# the stochastic-rounding draws never collide with (or shift) the Laplace
# draws of the round: a quantized run sees the same DP noise as the f32
# run under the same keys. The reference's engine folds the same salt in
# before it calls its codec (repro/federation/deep.py, _CODEC_SALT).
CODEC_SALT = 0x5142       # "QB"


def u01_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (any integer dtype holding them) -> floats in [0, 1)
    from the top 24 bits, exactly."""
    return (bits.to(torch.int64) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def det_bits(shape, device=None) -> torch.Tensor:
    """The uint32 pattern whose u01 is exactly 0.5: the deterministic
    round-to-nearest of bank init."""
    return torch.full(tuple(shape), 1 << 31, dtype=torch.int64, device=device).to(torch.uint32)


def counter_bits(seed: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """(n,) uint32 words: murmur3's fmix32 over index * 0x9E3779B9 + seed,
    the reference's cheap stream for stochastic-rounding bits (they
    perturb storage precision, never the DP noise). `seed` is a () uint32
    tensor; the indices are start .. start + n - 1 (a slice of a wider
    row), a uint32 counter, so start + n <= 2**32."""
    if start < 0 or start + n > 1 << 32 or n >= 1 << 32:
        raise ValueError(f"the counter stream indexes with uint32, got [{start}, "
                         f"{start + n})")
    i = torch.arange(start, start + n, dtype=torch.int64, device=seed.device)
    x = (_mul32(i, 0x9E3779B9) + (seed.to(torch.int64) & _MASK)) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x.to(torch.uint32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for x in [0, 2**32), in two 16-bit halves so that no
    int64 product exceeds 2**48."""
    high = (((x >> 16) * c) & 0xFFFF) << 16
    return (high + (x & 0xFFFF) * c) & _MASK


def sr_seed(key: torch.Tensor) -> torch.Tensor:
    """The () uint32 seed of one encode: bits(fold_in(key, CODEC_SALT), ())."""
    return random.bits(random.fold_in(key, CODEC_SALT), ())


def row_scales_ref(x2d: torch.Tensor, qmax: float) -> torch.Tensor:
    """(nb, be) f32 -> (nb,) scales = max(absmax, 1e-30) / qmax. amax and
    maximum keep NaN, as jnp.max and jnp.maximum do."""
    am = torch.amax(torch.abs(x2d.to(torch.float32)), dim=-1)
    return torch.maximum(am, torch.full_like(am, _TINY)) / torch.full_like(am, qmax)


def encode_int8_ref(x: torch.Tensor, bits: torch.Tensor, scale: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (codes int8, err f32) with err == x - codes*scale."""
    xf = x.to(torch.float32)
    q = torch.clamp(torch.floor(xf / scale + u01_from_bits(bits)), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), xf - q * scale


def decode_int8_ref(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def _fp8_decode_mag(b8: torch.Tensor) -> torch.Tensor:
    """|value| of e4m3fn magnitude bit patterns (sign bit 0): normal
    (8 + m) * 2^(e - 10) with the power of two built as an f32 bit
    pattern, subnormal m * 2^-9. Exact."""
    b = b8.to(torch.int32)
    e = b >> 3
    m = b & 7
    two_pow = ((e + 117) << 23).view(torch.float32)
    normal = (8 + m).to(torch.float32) * two_pow
    subnormal = m.to(torch.float32) * (1.0 / (1 << 9))
    return torch.where(e > 0, normal, subnormal)


def _fp8_floor_bits(a: torch.Tensor) -> torch.Tensor:
    """Largest e4m3fn magnitude pattern <= a, for a in [0, FP8_QMAX]: the
    f32 exponent (E - 120) and top three mantissa bits for normal values
    (truncation is floor for a >= 0), floor(a * 2^9) below 2^-6."""
    ab = a.contiguous().view(torch.int32)
    e = ((ab >> 23) & 0xFF) - 120
    m = (ab >> 20) & 0x7
    normal = ((e << 3) | m) & 0xFF
    subnormal = torch.floor(a * (1 << 9)).to(torch.int32) & 0xFF
    return torch.where(a < 1.0 / (1 << 6), subnormal, normal).to(torch.uint8)


def fp8_sr(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastically round f32 (|y| <= FP8_QMAX) onto the e4m3fn grid ->
    uint8 bit patterns. The upper neighbour is taken with probability
    (|y| - lo) / (hi - lo)."""
    a = torch.abs(y)
    lo8 = _fp8_floor_bits(a)
    hi8 = lo8 + 1
    lo = _fp8_decode_mag(lo8)
    hi = _fp8_decode_mag(hi8)
    p = torch.where(a > lo, (a - lo) / (hi - lo), torch.zeros_like(a))
    out8 = torch.where(u < p, hi8, lo8)
    return torch.where(y < 0, out8 | 0x80, out8)


def fp8_to_f32(codes: torch.Tensor) -> torch.Tensor:
    """e4m3fn uint8 bit patterns -> signed f32 values (0x7F/0xFF, which the
    encoder never writes, read as +-480 as in the reference)."""
    b = codes.to(torch.int32)
    mag = _fp8_decode_mag(b & 0x7F)
    return torch.where((b >> 7) > 0, -mag, mag)


def encode_fp8_ref(x: torch.Tensor, bits: torch.Tensor, scale: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (codes uint8 e4m3fn patterns, err f32)."""
    xf = x.to(torch.float32)
    y = torch.clamp(xf / scale, -FP8_QMAX, FP8_QMAX)
    codes = fp8_sr(y, u01_from_bits(bits))
    return codes, xf - fp8_to_f32(codes) * scale


def decode_fp8_ref(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return fp8_to_f32(codes) * scale


ENCODERS = {"int8": encode_int8_ref, "fp8": encode_fp8_ref}
DECODERS = {"int8": decode_int8_ref, "fp8": decode_fp8_ref}
QMAX = {"int8": INT8_QMAX, "fp8": FP8_QMAX}
# fp8 codes are stored as raw e4m3fn bit patterns (see fp8_sr)
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.uint8}


def _blocks(x: torch.Tensor, block_elems: Optional[int]) -> torch.Tensor:
    """(P,) -> (nb, be) zero-padded view; be = P for per-row scales."""
    p = x.shape[0]
    be = p if block_elems is None else int(block_elems)
    pad = (-p) % be
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, be)


def encode_row_ref(x: torch.Tensor, key: Optional[torch.Tensor], fmt: str, *,
                   block_elems: Optional[int] = None, deterministic: bool = False,
                   col0: int = 0, scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (P,) f32 row -> (codes (P,), scales (nb,), err (P,)), on x's
    device. The rounding bits are counter_bits(sr_seed(key)) at the
    element index (ref.det_bits when `deterministic`, which ignores key).
    A slice of a wider row passes its first column `col0` (its elements
    round with the counters of their columns) and the whole row's scales:
    its (1,) `scale`, or with `block_elems` its (nb,) block scales
    (`block_absmax_ref` of each slice, the max over the slices), each
    element taking its column's block's; the scales come back as given."""
    p = x.shape[0]
    if block_elems is not None and (col0 or scale is not None):
        if scale is None:
            raise ValueError("a slice of a row with per-block scales takes the row's (nb,) "
                             "scales (block_absmax_ref of every slice)")
        s = scale.reshape(-1).to(torch.float32)
        bits = (det_bits((p,), device=x.device) if deterministic
                else counter_bits(sr_seed(key), p, col0))
        codes, err = ENCODERS[fmt](x.to(torch.float32), bits,
                                   s[_column_blocks(p, block_elems, col0, x.device)])
        return codes, s, err
    x2 = _blocks(x.to(torch.float32), block_elems)
    scales = row_scales_ref(x2, QMAX[fmt]) if scale is None else scale.reshape(1)
    if deterministic:
        bits = det_bits(x2.shape, device=x.device)
    else:
        bits = counter_bits(sr_seed(key), x2.numel(), col0).reshape(x2.shape)
    codes2, err2 = ENCODERS[fmt](x2, bits, scales[:, None])
    return codes2.reshape(-1)[:p], scales, err2.reshape(-1)[:p]


def _column_blocks(p: int, block_elems: int, col0: int, device) -> torch.Tensor:
    """The block index of each of the columns [col0, col0 + p)."""
    return torch.arange(col0, col0 + p, dtype=torch.int64, device=device) // int(block_elems)


def block_absmax_ref(x: torch.Tensor, block_elems: int, col0: int, n_blocks: int
                     ) -> torch.Tensor:
    """(n_blocks,) f32: each block's max|x| over the columns [col0, col0 +
    P) of a wider row that `x` (P,) holds (0 for a block it does not
    reach; a NaN kept). The max of the slices' partials is the whole row's
    block absmax, bit for bit (`row_scales_ref` over (nb, be))."""
    be, p = int(block_elems), x.shape[0]
    b0 = col0 // be
    lead = col0 - b0 * be
    n_local = -(-(lead + p) // be)
    padded = x.new_zeros(n_local * be, dtype=torch.float32)
    padded[lead:lead + p] = torch.abs(x.to(torch.float32))
    out = x.new_zeros(n_blocks, dtype=torch.float32)
    out[b0:b0 + n_local] = torch.amax(padded.reshape(n_local, be), dim=-1)
    return out


def decode_row_ref(codes: torch.Tensor, scales: torch.Tensor, fmt: str, *,
                   block_elems: Optional[int] = None, col0: int = 0) -> torch.Tensor:
    """(P,) codes + (nb,) scales -> (P,) f32 row. With `block_elems`, codes
    may be the columns [col0, col0 + P) of a wider row whose (nb,) block
    scales are given: each element takes its column's block's."""
    p = codes.shape[0]
    if block_elems is not None and (col0 or scales.numel() != -(-p // int(block_elems))):
        return DECODERS[fmt](codes, scales.to(torch.float32)[
            _column_blocks(p, block_elems, col0, codes.device)])
    c2 = _blocks(codes, block_elems)
    return DECODERS[fmt](c2, scales.to(torch.float32)[:, None]).reshape(-1)[:p]
