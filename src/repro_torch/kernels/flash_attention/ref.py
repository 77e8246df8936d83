"""Plain PyTorch versions of the flash_attention kernel.

`attention_ref` is the counterpart of ``repro/kernels/flash_attention/
ref.py``: (B, H, S, hd) inputs, the whole (S, Skv) score matrix in f32,
masked to -1e30 and soft-maxed. `flash_attention_ref` takes the model
layout the kernel takes (q (B, S, H, hd), k and v (B, Skv, Kv, hd)),
repeats the kv heads for GQA and transposes around `attention_ref`. The
wrapper in ``ops.py`` runs it on CPU tensors, and the chip smoke script
holds the kernel against it on the card. It materializes (B, H, S, Skv)
f32 scores: an oracle, not a path.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (B, H, S, hd) with matching H. Returns (B, H, S, hd) in q's
    dtype."""
    S, hd = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, Kv, hd). Returns (B, S, H, hd)."""
    G = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, G, dim=2)
    v = torch.repeat_interleave(v, G, dim=2)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window)
    return out.transpose(1, 2)
