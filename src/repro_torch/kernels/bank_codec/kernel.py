"""CUDA kernels of the quantized owner bank, bound with ctypes.

The counterpart of ``repro/kernels/bank_codec/kernel.py``; the source is
``csrc/bank_codec.cu`` (what each kernel replaces, its bound and its
design are noted there). These functions launch on PyTorch's current
stream, allocate their outputs and scratch with ``torch.empty``, never
synchronise, and raise when the launch is refused. Each adds one to its
entry of `launches` when it launches, and nowhere else (`absmax` counts
its two passes as one launch), so a caller can show that a run went
through the kernels.
`repro_torch.telemetry.counters()` reads this `launches` in place, beside
the other kernels' and the pager's counters: the way to read them all.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bank_codec.ref import CODE_DTYPES, CODEC_SALT

NAME = "bank_codec"
SOURCE = Path(__file__).resolve().parent / "csrc" / "bank_codec.cu"

launches: Dict[str, int] = {"absmax": 0, "encode": 0, "decode": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load(NAME, SOURCE)
    lib.bank_absmax_num_partials.argtypes = [_I64]
    lib.bank_absmax_num_partials.restype = _I
    lib.bank_absmax_launch.argtypes = [_P, _I64, _F, _P, _P, _I, _P]
    lib.bank_absmax_launch.restype = _I
    lib.bank_encode_launch.argtypes = [_P, _P, _P, _U, _I, _I, _P, _P, _I64, _I64, _I, _P]
    lib.bank_encode_launch.restype = _I
    lib.bank_decode_launch.argtypes = [_P, _P, _I, _P, _I64, _I, _P]
    lib.bank_decode_launch.restype = _I
    return lib


def _cuda(t: torch.Tensor, op: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{op} needs CUDA tensors, got {t.device}")
    if t.numel() >= 1 << 32:
        raise ValueError(f"{op}: the rounding counter is uint32, got {t.numel()} elements")
    return t.device


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def row_scale_cuda(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """(1,) f32 scale max(max|x|, 1e-30) / qmax of a contiguous f32 row,
    written on the device by the two-pass absmax."""
    dev = _cuda(x, "row_scale_cuda")
    n = x.numel()
    _build.require(x, "x", torch.float32, dev, n)
    lib = _library()
    partial = torch.empty(lib.bank_absmax_num_partials(n), dtype=torch.float32, device=dev)
    scale = torch.empty(1, dtype=torch.float32, device=dev)
    err = lib.bank_absmax_launch(x.data_ptr(), n, qmax, partial.data_ptr(), scale.data_ptr(),
                                 dev.index, _stream(dev))
    _build.raise_on(err, "absmax")
    launches["absmax"] += 1
    return scale


def encode_cuda(x: torch.Tensor, scale: torch.Tensor, key: Optional[torch.Tensor], fmt: str,
                *, deterministic: bool = False, col0: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass -> (codes (P,), err (P,) f32). `scale` is the (1,) device
    scale; the rounding seed bits(fold_in(key, CODEC_SALT), ()) is derived
    in-kernel from the (2,) uint32 round `key` (unused when
    `deterministic`). `col0` is the row's first column in a wider row:
    element i rounds with the counter of column col0 + i."""
    dev = _cuda(x, "encode_cuda")
    n = x.numel()
    if col0 < 0 or col0 + n > 1 << 32:
        raise ValueError(f"encode_cuda: columns [{col0}, {col0 + n}) overflow the uint32 "
                         "rounding counter")
    _build.require(x, "x", torch.float32, dev, n)
    _build.require(scale, "scale", torch.float32, dev, 1)
    if deterministic:
        key_ptr = None
    else:
        _build.require(key, "key", torch.uint32, dev, 2)
        key_ptr = key.data_ptr()
    codes = torch.empty(n, dtype=CODE_DTYPES[fmt], device=dev)
    err_row = torch.empty(n, dtype=torch.float32, device=dev)
    err = _library().bank_encode_launch(
        x.data_ptr(), scale.data_ptr(), key_ptr, CODEC_SALT, int(deterministic),
        int(fmt == "fp8"), codes.data_ptr(), err_row.data_ptr(), n, int(col0), dev.index,
        _stream(dev))
    _build.raise_on(err, "encode")
    launches["encode"] += 1
    return codes, err_row


def decode_cuda(codes: torch.Tensor, scale: torch.Tensor, fmt: str) -> torch.Tensor:
    """codes (P,) int8 / e4m3fn uint8 patterns, (1,) device scale -> (P,) f32."""
    dev = _cuda(codes, "decode_cuda")
    n = codes.numel()
    _build.require(codes, "codes", CODE_DTYPES[fmt], dev, n)
    _build.require(scale, "scale", torch.float32, dev, 1)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    err = _library().bank_decode_launch(codes.data_ptr(), scale.data_ptr(), int(fmt == "fp8"),
                                        out.data_ptr(), n, dev.index, _stream(dev))
    _build.raise_on(err, "decode")
    launches["decode"] += 1
    return out
