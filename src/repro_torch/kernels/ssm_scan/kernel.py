"""CUDA kernel of the intra-chunk SSD contraction, bound with ctypes.

The counterpart of ``repro/kernels/ssm_scan/kernel.py``; the source is
``csrc/ssm_scan.cu`` (what it replaces, its bound and its design are noted
there). The wrapper launches on PyTorch's current stream, allocates its
outputs with ``torch.empty``, never synchronises, and raises when the
launch is refused. It adds one to `launches["ssd_chunk_scan"]` when it
launches, and nowhere else, so a caller can show that a run went through
the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

NAME = "ssm_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"

launches: Dict[str, int] = {"ssd_chunk_scan": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load(NAME, SOURCE)
    # v, ld, k, q, g, y, h_add, cum, tot; the (batch, sequence, head) strides
    # of v, ld, k, q, g; B, S, H, N, P, Q, dtype, vec, device; the stream
    lib.ssd_chunk_scan_launch.argtypes = [_P] * 9 + [_I64] * 15 + [_I] * 9 + [_P]
    lib.ssd_chunk_scan_launch.restype = _I
    return lib


def ssd_chunk_scan_cuda(v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                        g: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over every (batch, head, chunk of `chunk` positions).

    v (B, S, H, P); k and q (B, S, H, N), any strides with the last axis
    contiguous (a head stride of 0 broadcasts); ld and g (B, S, H) f32. v,
    k, q are f32 or bf16 alike; N and P multiples of 8 up to 128. Returns
    (y_intra (B, S, H, P), h_add (B, nc, H, N, P), cum (B, S, H),
    tot (B, nc, H)), all f32, with nc = ceil(S / chunk)."""
    dev = v.device
    if dev.type != "cuda" or any(t.device != dev for t in (ld, k, q, g)):
        raise ValueError("ssd_chunk_scan_cuda needs v, ld, k, q, g on one CUDA device")
    if v.dtype not in _DTYPES or k.dtype != v.dtype or q.dtype != v.dtype:
        raise TypeError(f"v, k, q must be f32 or bf16 alike, got {v.dtype}, {k.dtype}, "
                        f"{q.dtype}")
    if ld.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"ld and g must be f32, got {ld.dtype}, {g.dtype}")
    if v.dim() != 4 or k.dim() != 4 or k.shape != q.shape or ld.dim() != 3 or g.shape != ld.shape:
        raise ValueError(f"expected v (B, S, H, P), k and q (B, S, H, N), ld and g (B, S, H); "
                         f"got {tuple(v.shape)}, {tuple(k.shape)}, {tuple(q.shape)}, "
                         f"{tuple(ld.shape)}, {tuple(g.shape)}")
    B, S, H, P = v.shape
    N = k.shape[-1]
    if tuple(k.shape[:3]) != (B, S, H) or tuple(ld.shape) != (B, S, H):
        raise ValueError(f"k {tuple(k.shape)} and ld {tuple(ld.shape)} do not fit v "
                         f"{tuple(v.shape)}")
    if N % 8 or P % 8 or not (8 <= N <= 128 and 8 <= P <= 128):
        raise ValueError(f"d_state N and head dim P must be multiples of 8 up to 128, got "
                         f"{N}, {P}")
    if any(t.stride(3) != 1 for t in (v, k, q)):
        raise ValueError("v, k and q must be contiguous in their last axis")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    nc = -(-S // chunk)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    h_add = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
    cum = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    tot = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, h_add, cum, tot
    vec = int(all(_build.rows_aligned(t) for t in (v, k, q)))
    strides = [s for t in (v, ld, k, q, g) for s in t.stride()[:3]]
    err = _library().ssd_chunk_scan_launch(
        v.data_ptr(), ld.data_ptr(), k.data_ptr(), q.data_ptr(), g.data_ptr(), y.data_ptr(),
        h_add.data_ptr(), cum.data_ptr(), tot.data_ptr(), *strides, B, S, H, N, P, chunk,
        _DTYPES[v.dtype], vec, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "ssd_chunk_scan")
    launches["ssd_chunk_scan"] += 1
    return y, h_add, cum, tot
