"""GQA attention, training path: projections and causal attention.

Counterpart of the training half of ``repro/models/attention.py``, with
its layouts:

  activations  x        : (B, S, d)
  queries      q        : (B, S, H, hd)
  keys/values  k, v     : (B, S, Kv, hd)
  weights      wq       : (d, H, hd)     wk/wv: (d, Kv, hd)    wo: (H, hd, d)

`causal_attention` computes what the reference's `blockwise_attention`
computes (causal mask, GQA head groups, f32 softmax) with plain torch ops
in one block; the online-softmax chunking there is a memory device only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, dense_init, rope_freqs

NEG_INF = -1e30


class AttnParams(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


def init_attention(generator: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, qkv_bias: bool, dtype=torch.float32) -> AttnParams:
    def w(*shape):
        return dense_init(shape, generator, dtype)

    p = AttnParams(w(d_model, n_heads, head_dim), w(d_model, n_kv, head_dim),
                   w(d_model, n_kv, head_dim), w(n_heads, head_dim, d_model))
    if qkv_bias:
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=generator.device)
        p = p._replace(bq=z(n_heads, head_dim), bk=z(n_kv, head_dim), bv=z(n_kv, head_dim))
    return p


def qkv_proj(p: AttnParams, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def out_proj(p: AttnParams, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,S,Kv,hd) -> (B,S,H,hd). Masked softmax in f32."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, hd)
    s = torch.einsum("bqkgh,bckh->bqkgc", qg.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    mask = (positions[:, None] - positions[None, :]) >= 0          # (S, S)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, hd).to(q.dtype)


def attention_forward(p: AttnParams, x: torch.Tensor, *, positions: torch.Tensor,
                      rope_theta: float) -> torch.Tensor:
    q, k, v = qkv_proj(p, x)
    cos, sin = rope_freqs(positions, q.shape[-1], rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    return out_proj(p, causal_attention(q, k, v, positions))
