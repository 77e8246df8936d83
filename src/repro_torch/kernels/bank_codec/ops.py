"""Row-level entry points of the owner-bank codec (int8 / fp8 + EF).

    codes, scales, err = encode_row(row, key, "int8")   # (P,), (nb,), (P,)
    row_hat = decode_row(codes, scales, "int8")         # (P,) f32

The counterpart of ``repro/kernels/bank_codec/ops.py``. The backend follows
the tensor: a CPU tensor runs the plain version from ``ref.py``; a CUDA
tensor launches the kernels from ``kernel.py`` (absmax, then encode; or
decode), and a failed build or launch raises. There is no fallback from
one to the other.

RNG contract: the stochastic-rounding bits are ``ref.counter_bits``
seeded by bits(fold_in(key, ref.CODEC_SALT), ()) (not privacy-critical:
they perturb storage precision, never the DP noise). The reference's
engine folds the same salt into the round key before its codec draws
bits(key, ()), so ``encode_row(x, key)`` here equals the reference's
``encode_row(x, fold_in(key, 0x5142))``. The kernel derives the seed
in-kernel from the round key, so the engine never runs the threefry hash
as tensor ops on the card. The counter is the element index, which is
also the flat index of the reference's padded (R, 1024) kernel draw, so
the kernel, the plain version and both reference backends round with the
same bits.

``block_elems`` switches to per-block f32 scales (the row cut into
ceil(P / block_elems) segments). As in the reference, only the plain
version runs it: on CUDA it raises NotImplementedError. ``deterministic``
rounds to nearest (u = 0.5), the keyless encode of bank init.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.bank_codec import kernel
from repro_torch.kernels.bank_codec.ref import (CODE_DTYPES, QMAX, block_absmax_ref,
                                                decode_row_ref, encode_row_ref, row_scales_ref)

FORMATS = tuple(CODE_DTYPES)


def code_dtype(fmt: str) -> torch.dtype:
    if fmt not in CODE_DTYPES:
        raise ValueError(f"unknown bank codec {fmt!r} (supported: {', '.join(FORMATS)})")
    return CODE_DTYPES[fmt]


def n_scales(p: int, block_elems: Optional[int]) -> int:
    return 1 if block_elems is None else -(-p // int(block_elems))


def _unsupported(t: torch.Tensor, op: str) -> ValueError:
    return ValueError(f"{op}: tensors on {t.device} are not supported "
                      "(cpu runs the plain version, cuda the kernel)")


def _per_block_on_cuda(op: str) -> NotImplementedError:
    return NotImplementedError(f"{op}: per-block scales run on the plain version only "
                               "(the kernel keeps one scale per row)")


def row_scale(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """(1,) f32 scale of a (P,) f32 row: max(max|x|, 1e-30) / qmax."""
    code_dtype(fmt)
    if x.device.type == "cpu":
        return row_scales_ref(x.reshape(1, -1), QMAX[fmt])
    if x.device.type == "cuda":
        return kernel.row_scale_cuda(x, QMAX[fmt])
    raise _unsupported(x, "row_scale")


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """(1,) f32 max(max|x|, 1e-30) of a (P,) f32 row (NaN if x holds one):
    a slice's partial of the row scale. The max of the slices' partials,
    through `scale_from_absmax`, is bit for bit `row_scale` of the whole
    row. On CUDA this is the absmax kernel at qmax 1."""
    if x.device.type == "cpu":
        return row_scales_ref(x.reshape(1, -1), 1.0)
    if x.device.type == "cuda":
        return kernel.row_scale_cuda(x, 1.0)
    raise _unsupported(x, "row_absmax")


def scale_from_absmax(partials: torch.Tensor, fmt: str) -> torch.Tensor:
    """(1,) scale of a row from its slices' `row_absmax` partials (any
    shape): max(max partials, 1e-30) / qmax, keeping a NaN as the absmax
    kernel does."""
    return row_scales_ref(partials.reshape(1, -1), QMAX[fmt])


def block_absmax(x: torch.Tensor, block_elems: int, col0: int, n_blocks: int) -> torch.Tensor:
    """(n_blocks,) f32 per-block max|x| of the columns [col0, col0 + P) of
    a row that `x` holds: a slice's partials of the row's block scales
    (`block_absmax_ref`; per-block scales run on the plain version only)."""
    if x.device.type == "cpu":
        return block_absmax_ref(x, block_elems, col0, n_blocks)
    if x.device.type == "cuda":
        raise _per_block_on_cuda("block_absmax")
    raise _unsupported(x, "block_absmax")


def block_scales_from_absmax(partials: torch.Tensor, fmt: str) -> torch.Tensor:
    """(nb,) block scales from the max of the slices' `block_absmax`:
    max(absmax, 1e-30) / qmax per block, a NaN kept."""
    return row_scales_ref(partials.reshape(-1, 1), QMAX[fmt])


def encode_row(x: torch.Tensor, key: Optional[torch.Tensor], fmt: str, *,
               block_elems: Optional[int] = None, deterministic: bool = False,
               col0: int = 0, scale: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize one (P,) f32 row -> (codes (P,), scales (nb,), err (P,)).

    err = x - decode(codes, scales) in f32, the error-feedback residual.
    `key` is the (2,) uint32 round key (ignored when `deterministic`). A
    slice of a wider row (a rank's columns on a device mesh) passes its
    first column `col0`, so each element rounds with its column's bits,
    and the whole row's (1,) `scale` (`scale_from_absmax`), or with
    `block_elems` its (nb,) block scales (`block_scales_from_absmax`);
    None computes the scale of `x`."""
    code_dtype(fmt)
    if x.device.type == "cpu":
        return encode_row_ref(x, key, fmt, block_elems=block_elems,
                              deterministic=deterministic, col0=col0, scale=scale)
    if x.device.type == "cuda":
        if block_elems is not None:
            raise _per_block_on_cuda("encode_row")
        if scale is None:
            scale = kernel.row_scale_cuda(x, QMAX[fmt])
        codes, err = kernel.encode_cuda(x, scale, key, fmt, deterministic=deterministic,
                                        col0=col0)
        return codes, scale, err
    raise _unsupported(x, "encode_row")


def decode_row(codes: torch.Tensor, scales: torch.Tensor, fmt: str, *,
               block_elems: Optional[int] = None, col0: int = 0) -> torch.Tensor:
    """(P,) codes + (nb,) scales -> (P,) f32 row; with `block_elems` the
    codes may be the columns from `col0` of a wider row (`decode_row_ref`)."""
    code_dtype(fmt)
    if codes.device.type == "cpu":
        return decode_row_ref(codes, scales, fmt, block_elems=block_elems, col0=col0)
    if codes.device.type == "cuda":
        if block_elems is not None:
            raise _per_block_on_cuda("decode_row")
        return kernel.decode_cuda(codes, scales, fmt)
    raise _unsupported(codes, "decode_row")
