"""CUDA kernels of the intra-chunk SSD contraction and of its backward,
bound with ctypes.

`ssd_chunk_scan_cuda` is the counterpart of
``repro/kernels/ssm_scan/kernel.py``; `ssd_chunk_scan_bwd_cuda` is the
port's own (the reference has no backward kernel: jax differentiates its
plain scan). The source of both is ``csrc/ssm_scan.cu`` (what they
replace, their bounds and their designs are noted there). The wrappers
launch on PyTorch's current stream, allocate their outputs with
``torch.empty``, never synchronise, and raise when a launch is refused.
Each adds one to its own count, `launches["ssd_chunk_scan"]` or
`launches["ssd_chunk_scan_bwd"]`, when it launches, and nowhere else, so a
caller can show that a run went through the kernels.

Both launches are custom ops (``torch.ops.repro_torch.ssd_chunk_scan_cuda``
and ``ssd_chunk_scan_bwd_cuda``, `torch.library.custom_op`), so dispatch
sees them: a TorchDispatchMode (``analysis.op_cost``) counts them by their
registered flop formulas (PERF.md, rows 9 and 10), and on the meta device
their fakes give the outputs' shapes without launching. `ops.SSDChunkScan`
keeps their autograd and vmap rules.
`repro_torch.telemetry.counters()` reads this `launches` in place, beside
the other kernels' and the pager's counters: the way to read them all.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NAME = "ssm_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"

launches: Dict[str, int] = {"ssd_chunk_scan": 0, "ssd_chunk_scan_bwd": 0}

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
    # dy, dh, dcum, dtot, v, ld, k, q, g, dv, dld, dk, dq, dg; the (batch,
    # sequence, head) strides of v, ld, k, q, g; B, S, H, N, P, Q, dtype,
    # vec, device; the stream; the wide variant's (3, B, S, H) f32 scratch
    lib.ssd_chunk_scan_bwd_launch.argtypes = [_P] * 14 + [_I64] * 15 + [_I] * 9 + [_P, _P]
    lib.ssd_chunk_scan_bwd_launch.restype = _I
    return lib


# the wide variant's limits (ssm_scan.cu: kWideMax, kWQ)
WIDE_MAX = 512
WIDE_CHUNK = 256


def narrow_heads(N: int, P: int) -> bool:
    """Whether heads of d_state N and head dim P take the resident-tile
    variants (both multiples of 8 up to 128) or the wide one (any other N
    and P up to WIDE_MAX, chunks up to WIDE_CHUNK: the mLSTM's N = dm / H
    and P = N + 1)."""
    return N % 8 == 0 and P % 8 == 0 and 8 <= N <= 128 and 8 <= P <= 128


def _check_inputs(v, ld, k, q, g, chunk, what):
    """The checks both kernels make on the forward's inputs."""
    dev = v.device
    if dev.type != "cuda" or any(t.device != dev for t in (ld, k, q, g)):
        raise ValueError(f"{what} needs v, ld, k, q, g on one CUDA device")
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
    if not narrow_heads(N, P):
        if not (1 <= N <= WIDE_MAX and 1 <= P <= WIDE_MAX):
            raise ValueError(f"d_state N and head dim P must be at most {WIDE_MAX}, got {N}, {P}")
        if chunk > WIDE_CHUNK:
            raise ValueError(f"heads of N {N}, P {P} take chunks of at most {WIDE_CHUNK} "
                             f"positions, got {chunk}")
    if any(t.stride(3) != 1 for t in (v, k, q)):
        raise ValueError("v, k and q must be contiguous in their last axis")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return B, S, H, N, P, -(-S // chunk)


@torch.library.custom_op("repro_torch::ssd_chunk_scan_cuda", mutates_args=())
def ssd_chunk_scan_cuda(v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                        g: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over every (batch, head, chunk of `chunk` positions).

    v (B, S, H, P); k and q (B, S, H, N), any strides with the last axis
    contiguous (a head stride of 0 broadcasts); ld and g (B, S, H) f32. v,
    k, q are f32 or bf16 alike; N and P up to WIDE_MAX (`narrow_heads`
    picks the variant; wide heads take chunks up to WIDE_CHUNK). Returns
    (y_intra (B, S, H, P), h_add (B, nc, H, N, P), cum (B, S, H),
    tot (B, nc, H)), all f32, with nc = ceil(S / chunk)."""
    B, S, H, N, P, nc = _check_inputs(v, ld, k, q, g, chunk, "ssd_chunk_scan_cuda")
    dev = v.device
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


@torch.library.custom_op("repro_torch::ssd_chunk_scan_bwd_cuda", mutates_args=())
def ssd_chunk_scan_bwd_cuda(dy: torch.Tensor, dh: torch.Tensor, dcum: torch.Tensor,
                            dtot: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
                            k: torch.Tensor, q: torch.Tensor, g: torch.Tensor, chunk: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One launch over every (batch, head, chunk): the backward of
    `ssd_chunk_scan_cuda` at the same inputs (v, ld, k, q, g, chunk, taken
    as that function takes them), from the cotangents of its four outputs
    (dy (B, S, H, P), dh (B, nc, H, N, P), dcum (B, S, H), dtot (B, nc,
    H), any float dtype and strides: they are made contiguous f32 here).
    Returns (dv, dld, dk, dq, dg): dv (B, S, H, P) in v's dtype, dk and dq
    dense (B, S, H, N) in k's dtype (also where k and q broadcast), dld
    and dg (B, S, H) f32."""
    B, S, H, N, P, nc = _check_inputs(v, ld, k, q, g, chunk, "ssd_chunk_scan_bwd_cuda")
    dev = v.device
    cots = []
    for t, shape, what in ((dy, (B, S, H, P), "dy"), (dh, (B, nc, H, N, P), "dh"),
                           (dcum, (B, S, H), "dcum"), (dtot, (B, nc, H), "dtot")):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{what} {tuple(t.shape)} on {t.device} does not fit "
                             f"{shape} on {dev}")
        cots.append(t.to(torch.float32).contiguous())
    dv = torch.empty((B, S, H, P), dtype=v.dtype, device=dev)
    dk = torch.empty((B, S, H, N), dtype=k.dtype, device=dev)
    dq = torch.empty((B, S, H, N), dtype=q.dtype, device=dev)
    dld = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dg = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    if dv.numel() == 0:
        return dv, dld, dk, dq, dg
    vec = int(all(_build.rows_aligned(t) for t in (v, k, q)))
    strides = [s for t in (v, ld, k, q, g) for s in t.stride()[:3]]
    # the wide variant's q . dq, k . dk and w k^T dh u, between its two kernels
    scratch = (None if narrow_heads(N, P)
               else torch.empty((3, B, S, H), dtype=torch.float32, device=dev))
    err = _library().ssd_chunk_scan_bwd_launch(
        *(t.data_ptr() for t in cots), v.data_ptr(), ld.data_ptr(), k.data_ptr(), q.data_ptr(),
        g.data_ptr(), dv.data_ptr(), dld.data_ptr(), dk.data_ptr(), dq.data_ptr(),
        dg.data_ptr(), *strides, B, S, H, N, P, chunk, _DTYPES[v.dtype], vec, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
        None if scratch is None else scratch.data_ptr())
    _build.raise_on(err, "ssd_chunk_scan_bwd")
    launches["ssd_chunk_scan_bwd"] += 1
    return dv, dld, dk, dq, dg


@ssd_chunk_scan_cuda.register_fake
def _(v, ld, k, q, g, chunk):
    B, S, H, P = v.shape
    N, nc = k.shape[-1], -(-S // chunk)
    f32 = torch.float32
    return (v.new_empty((B, S, H, P), dtype=f32), v.new_empty((B, nc, H, N, P), dtype=f32),
            v.new_empty((B, S, H), dtype=f32), v.new_empty((B, nc, H), dtype=f32))


@ssd_chunk_scan_bwd_cuda.register_fake
def _(dy, dh, dcum, dtot, v, ld, k, q, g, chunk):
    B, S, H, P = v.shape
    N, f32 = k.shape[-1], torch.float32
    return (v.new_empty((B, S, H, P)), v.new_empty((B, S, H), dtype=f32),
            k.new_empty((B, S, H, N)), q.new_empty((B, S, H, N)),
            v.new_empty((B, S, H), dtype=f32))


def chunk_rows(S: int, chunk: int):
    """The positions of each chunk: `chunk`, and a ragged last one."""
    return [min(chunk, S - c) for c in range(0, S, chunk)]


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_scan_cuda)
def ssd_chunk_scan_flops(v_shape, ld_shape, k_shape, q_shape, g_shape, chunk,
                         out_shape=None, **kw) -> int:
    """PERF.md, row 9: B H sum over chunks of Q (Q + 1) / 2 (N + P) 2 +
    Q N P 2, Q each chunk's positions."""
    B, S, H, P = v_shape
    N = k_shape[-1]
    return B * H * sum(r * (r + 1) // 2 * (N + P) * 2 + r * N * P * 2
                       for r in chunk_rows(S, chunk))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_scan_bwd_cuda)
def ssd_chunk_scan_bwd_flops(dy_shape, dh_shape, dcum_shape, dtot_shape, v_shape, ld_shape,
                             k_shape, q_shape, g_shape, chunk, out_shape=None, **kw) -> int:
    """PERF.md, row 10: B H sum over chunks of Q (Q + 1) / 2 (3 N + 2 P) 2
    + 2 Q N P 2."""
    B, S, H, P = v_shape
    N = k_shape[-1]
    return B * H * sum(r * (r + 1) // 2 * (3 * N + 2 * P) * 2 + 2 * r * N * P * 2
                       for r in chunk_rows(S, chunk))
