"""CUDA kernels of the flat async-DP round, bound with ctypes.

The counterpart of ``repro/kernels/dp_clip_noise/kernel.py``; the source
is ``csrc/dp_clip_noise.cu`` (what each kernel replaces, its bound and its
design are noted there). These functions launch on PyTorch's current
stream, allocate their outputs and scratch with ``torch.empty``, never
synchronise, and raise when the launch is refused. Each adds one to its
entry of `launches` when it launches, and nowhere else, so a caller can
show that a run went through the kernels. The `*_rows_cuda` forms take a
member axis (g contiguous rows, one launch for all of them) and count one
launch under the same name.
`repro_torch.telemetry.counters()` reads this `launches` in place, beside
the other kernels' and the pager's counters: the way to read them all.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

NAME = "dp_clip_noise"
SOURCE = Path(__file__).resolve().parent / "csrc" / "dp_clip_noise.cu"

launches: Dict[str, int] = {"dp_round": 0, "scale_noise": 0, "sqnorm": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_I64 = ctypes.c_longlong
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load(NAME, SOURCE)
    lib.dp_round_rows_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                         _F, _F, _F, _F, _F, _I, _P]
    lib.dp_round_rows_launch.restype = _I
    lib.scale_noise_launch.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                       _I64, _I, _P]
    lib.scale_noise_launch.restype = _I
    lib.sqnorm_num_partials.argtypes = [_I64]
    lib.sqnorm_num_partials.restype = _I
    lib.sqnorm_rows_launch.argtypes = [_P, _I64, _I64, _P, _P, _I, _P]
    lib.sqnorm_rows_launch.restype = _I
    return lib


def _rows_of(x: torch.Tensor, what: str) -> Tuple[int, int]:
    """(g, P) of a 2-d tensor; raises otherwise."""
    if x.dim() != 2:
        raise ValueError(f"{what} must be (g, P), got shape {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def dp_round_rows_cuda(tb: torch.Tensor, acc: torch.Tensor, keys: torch.Tensor,
                       gain: torch.Tensor, noise_scale: torch.Tensor, w: torch.Tensor,
                       *, sigma: float, lr_own: float, lr_l: float, inv_2n: float,
                       theta_max: float, col0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the fused round over g members -> (new_L, new_i), each
    (g, P): row m of `tb` and `acc` (g, P) f32 with key `keys[m]` ((g, 2)
    uint32) and the m-th of `gain`, `noise_scale` and `w` ((g,) f32), all on
    the buffers' device. Row m equals dp_round_cuda on row m bit for bit.
    `col0` is the rows' first column in a wider row: element i draws the
    bits of column col0 + i."""
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"dp_round_rows_cuda needs CUDA tensors, got {dev}")
    g, n = _rows_of(tb, "theta_bar")
    _build.require(tb, "theta_bar", torch.float32, dev, g * n)
    _build.require(acc, "acc", torch.float32, dev, g * n)
    _build.require(keys, "keys", torch.uint32, dev, 2 * g)
    for what, s in (("gain", gain), ("noise_scale", noise_scale), ("w", w)):
        _build.require(s, what, torch.float32, dev, g)
    new_l = torch.empty_like(tb)
    new_i = torch.empty_like(tb)
    err = _library().dp_round_rows_launch(
        tb.data_ptr(), acc.data_ptr(), keys.data_ptr(), gain.data_ptr(),
        noise_scale.data_ptr(), w.data_ptr(), new_l.data_ptr(), new_i.data_ptr(),
        g, n, int(col0), sigma, lr_own, lr_l, inv_2n, theta_max, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "dp_round")
    launches["dp_round"] += 1
    return new_l, new_i


def dp_round_cuda(tb: torch.Tensor, acc: torch.Tensor, key: torch.Tensor,
                  gain: torch.Tensor, noise_scale: torch.Tensor, w: torch.Tensor,
                  **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused round on one (P,) f32 buffer -> (new_L, new_i): the
    batched launch with one row. `key` is the round's (2,) uint32 key;
    `gain`, `noise_scale` and `w` are one-element f32 tensors, all on the
    buffer's device; `kw` as dp_round_rows_cuda's."""
    new_l, new_i = dp_round_rows_cuda(tb.view(1, -1), acc.view(1, -1), key, gain,
                                      noise_scale, w, **kw)
    return new_l[0], new_i[0]


def scale_noise_cuda(g: torch.Tensor, key: torch.Tensor, clip_scale: torch.Tensor,
                     noise_scale: torch.Tensor,
                     layout: Optional[Tuple[int, int, int, int, int]] = None) -> torch.Tensor:
    """One launch of g * clip_scale + noise_scale * Laplace(bits) over a
    contiguous f32 tensor of any shape -> a new tensor of g's shape.

    The bits are random.bits(key, (g.numel(),)), hashed in-kernel; `key` is
    the leaf's (2,) uint32 key, `clip_scale` and `noise_scale` one-element
    f32 tensors, all on g's device. `layout` (base, R, C, SR, SA) makes g a
    block of a larger leaf, seen as (A, R, C): element (a, r, c) draws the
    bits of the leaf's flat index base + a*SA + r*SR + c (ops.py's
    `_block_layout` computes it); None is the whole leaf."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"scale_noise_cuda needs CUDA tensors, got {dev}")
    n = g.numel()
    base, R, C, SR, SA = (0, 1, n, n, n) if layout is None else layout
    _build.require(g, "g", torch.float32, dev, n)
    _build.require(key, "key", torch.uint32, dev, 2)
    _build.require(clip_scale, "clip_scale", torch.float32, dev, 1)
    _build.require(noise_scale, "noise_scale", torch.float32, dev, 1)
    out = torch.empty_like(g, memory_format=torch.contiguous_format)
    err = _library().scale_noise_launch(
        g.data_ptr(), key.data_ptr(), clip_scale.data_ptr(), noise_scale.data_ptr(),
        out.data_ptr(), n, base, R, C, SR, SA, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "scale_noise")
    launches["scale_noise"] += 1
    return out


def sqnorm_rows_cuda(g: torch.Tensor) -> torch.Tensor:
    """Deterministic sum of squares of each row of a contiguous (rows, P)
    f32 tensor -> (rows,), in one launch; row m equals sqnorm_cuda on the
    view g[m] bit for bit."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"sqnorm_rows_cuda needs a CUDA tensor, got {dev}")
    rows, n = _rows_of(g, "g")
    _build.require(g, "g", torch.float32, dev, rows * n)
    lib = _library()
    partial = torch.empty(rows * lib.sqnorm_num_partials(n), dtype=torch.float32, device=dev)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    err = lib.sqnorm_rows_launch(g.data_ptr(), rows, n, partial.data_ptr(), out.data_ptr(),
                                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "sqnorm")
    launches["sqnorm"] += 1
    return out


def sqnorm_cuda(g: torch.Tensor) -> torch.Tensor:
    """Deterministic sum of g*g over a contiguous f32 tensor of any shape ->
    0-d tensor on the same device: the batched launch with one row."""
    return sqnorm_rows_cuda(g.view(1, -1))[0]
