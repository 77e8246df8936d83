"""CUDA kernel of flash attention (forward), bound with ctypes.

The counterpart of ``repro/kernels/flash_attention/kernel.py``; the source
is ``csrc/flash_attention.cu`` (what it replaces, its bound and its design
are noted there). The wrapper launches on PyTorch's current stream,
allocates the output with ``torch.empty``, never synchronises, and raises
when the launch is refused. It adds one to `launches["flash_attention"]`
when it launches, and nowhere else, so a caller can show that a run went
through the kernel.

The launch is the custom op ``torch.ops.repro_torch.flash_attention_cuda``
(`torch.library.custom_op`), so dispatch sees it: a TorchDispatchMode
(``analysis.op_cost``) counts it by its registered flop formula (PERF.md,
row 8: 4 B H hd times the (query, key) pairs the mask keeps), and on the
meta device its fake gives the output's shape without launching.
`repro_torch.telemetry.counters()` reads this `launches` in place, beside
the other kernels' and the pager's counters: the way to read them all.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

launches: Dict[str, int] = {"flash_attention": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load(NAME, SOURCE)
    # q, k, v, out; the (batch, sequence, head) strides of q, k, v; B, S,
    # Skv, H, Kv, hd, causal, window, dtype, vec; scale; device; the stream
    lib.flash_attention_launch.argtypes = ([_P] * 4 + [_I64] * 9 + [_I] * 10
                                           + [ctypes.c_float, _I, _P])
    lib.flash_attention_launch.restype = _I
    return lib


def _strides(t: torch.Tensor, what: str):
    """(batch, sequence, head) element strides of a (B, S, heads, hd)
    tensor whose last dimension is contiguous."""
    if t.stride(3) != 1:
        raise ValueError(f"{what} must be contiguous in its last (head_dim) dimension, "
                         f"got strides {t.stride()}")
    return t.stride(0), t.stride(1), t.stride(2)


@torch.library.custom_op("repro_torch::flash_attention_cuda", mutates_args=())
def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """One launch. q: (B, S, H, hd); k, v: (B, Skv, Kv, hd), all on one
    CUDA device, f32 or bf16 alike, last dimension contiguous; hd a
    multiple of 8 up to 128, Kv dividing H. Returns a new contiguous
    (B, S, H, hd) tensor of q's dtype."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes f32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, H, hd) and k, v (B, Skv, Kv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kv == 0 or H % Kv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"head_dim must be a multiple of 8 up to 128, got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    vec = int(all(_build.rows_aligned(t) for t in (q, k, v)))
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
        B, S, Skv, H, Kv, hd, int(causal), 0 if window is None else int(window),
        _DTYPES[q.dtype], vec, hd ** -0.5, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out


@flash_attention_cuda.register_fake
def _(q, k, v, *, causal=True, window=None):
    return q.new_empty(q.shape).contiguous()


def attended_pairs(S: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps: query i (0 <= i < S) sees key
    j (0 <= j < Skv) with j <= i when causal and i - j < window under a
    window, as the kernel and ``ref.attention_ref`` mask them."""
    import numpy as np
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(S, Skv - 1, np.int64)
    lo = np.maximum(i - int(window) + 1, 0) if window is not None else np.zeros(S, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_cuda)
def flash_attention_flops(q_shape, k_shape, v_shape, *, causal=True, window=None,
                          out_shape=None, **kw) -> int:
    """PERF.md, row 8: two products of 2 B H hd operations a kept (query,
    key) pair (4 B H hd S (S + 1) / 2 causal at Skv = S)."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * attended_pairs(S, k_shape[1], causal, window)
