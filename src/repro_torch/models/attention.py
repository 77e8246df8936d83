"""GQA/MQA attention: the blockwise online-softmax forward, the flash
kernel, and cached decode. Counterpart of ``repro/models/attention.py``,
with its layouts:

  activations  x        : (B, S, d)
  queries      q        : (B, S, H, hd)
  keys/values  k, v     : (B, S, Kv, hd)
  weights      wq       : (d, H, hd)     wk/wv: (d, Kv, hd)    wo: (H, hd, d)
KV caches:
  full  : (B, S_max, Kv, hd), write at `pos`
  ring  : (B, W, Kv, hd), write at `pos % W`  (sliding-window layers)

`attention_forward(..., backend="jnp")` runs `blockwise_attention`, plain
torch ops whose memory is O(S * kv_chunk); ``backend="pallas"`` runs
``kernels.flash_attention.ops.flash_attention`` (its plain version on a CPU
tensor, the Hopper kernel on a CUDA tensor). The two spellings are the
reference's, so a call reads the same in both packages.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
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


# ---------------------------------------------------------------------------
# training / prefill attention: a loop over kv chunks with online softmax.
# Memory per step is O(S * kv_chunk) instead of O(S^2).
# ---------------------------------------------------------------------------
def _kv_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees. Non-causal attention
    masks only keys at negative positions."""
    dp = q_positions[:, None] - kv_positions[None, :]
    mask = dp >= 0 if causal else (kv_positions >= 0)[None, :].expand_as(dp)
    if window is not None:
        mask = mask & (dp < window)
    return mask


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,Kv,hd). Returns (B,Sq,H,hd).

    Scores and the accumulator in f32; the probabilities meet v in q's
    dtype, as the reference's bf16 operands with f32 accumulation do. A
    ragged last chunk is a shorter slice, so it needs no padding: the
    reference pads it with keys at position -1e9, which its causal mask
    without a window lets through (ROADMAP, faults).

    With one chunk (Skv <= kv_chunk, as in the federation model's training
    forward) the online rescaling is the identity, so that case is a plain
    masked softmax: the same numbers in f32 from fewer ops, forward and
    backward."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if Skv <= kv_chunk:
        mask = _kv_mask(q_positions, kv_positions, causal, window)
        return plain_attention(q, k, v, mask=mask[None, :, None, None, :])
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, hd).to(torch.float32)
    scale = hd ** -0.5
    m = torch.full((B, Sq, Kv, G), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, Sq, Kv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Kv, G, hd), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, kv_chunk):
        kj = k[:, start:start + kv_chunk].to(torch.float32)
        vj = v[:, start:start + kv_chunk]
        pj = kv_positions[start:start + kv_chunk]
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, kj) * scale
        mask = _kv_mask(q_positions, pj, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        o = torch.einsum("bqkgc,bckh->bqkgh", p.to(q.dtype).to(torch.float32),
                         vj.to(torch.float32))
        acc = acc * corr[..., None] + o
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole score matrix at once: decode, the encoder's bidirectional
    attention, cross-attention, and the blockwise path's one-chunk case.
    GQA-aware; `mask` (None: every key) broadcasts against the (B, Sq, Kv,
    G, Skv) scores."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, k.to(torch.float32)) * hd ** -0.5
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------
def attention_forward(p: AttnParams, x: torch.Tensor, *, positions: torch.Tensor,
                      rope_theta: float, causal: bool = True, window: Optional[int] = None,
                      kv_chunk: int = 1024, backend: str = "jnp") -> torch.Tensor:
    """backend: "jnp" (blockwise online softmax, plain torch ops) or
    "pallas" (the flash kernel's entry point)."""
    q, k, v = qkv_proj(p, x)
    cos, sin = rope_freqs(positions, q.shape[-1], rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    if backend == "pallas":
        o = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif backend == "jnp":
        o = blockwise_attention(q, k, v, q_positions=positions, kv_positions=positions,
                                causal=causal, window=window, kv_chunk=kv_chunk)
    else:
        raise ValueError(f"unknown attention backend {backend!r} (expected 'jnp' or 'pallas')")
    return out_proj(p, o)


def encoder_attention(p: AttnParams, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional, no RoPE (the whisper encoder adds learned absolute
    positions)."""
    q, k, v = qkv_proj(p, x)
    return out_proj(p, plain_attention(q, k, v))


def cross_attention(p: AttnParams, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor) -> torch.Tensor:
    """x's queries against the encoder's keys and values (`cross_kv`), no
    mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    return out_proj(p, plain_attention(q, enc_k, enc_v))


def cross_kv(p: AttnParams, enc_out: torch.Tensor):
    """The keys and values (B, S_enc, Kv, hd) of the encoder's output."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p.wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, p.wv)
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return k, v


# ---------------------------------------------------------------------------
# decode (one token) against a cache
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, Kv, hd) — C = S_max (full) or W (ring)
    v: torch.Tensor


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """A zero cache on `device` (CUDA when None)."""
    device = resolve_device(device)
    shape = (batch, capacity, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(p: AttnParams, x: torch.Tensor, cache: KVCache, pos: int, *,
                     rope_theta: float, ring: bool, window: Optional[int] = None):
    """One-token decode. x: (B, 1, d); pos: the current position (an int).

    `ring`: True for sliding-window caches whose capacity is the window
    (slot = pos % C); False for full caches (slot = pos). The token's k and
    v are written into `cache` IN PLACE (the reference returns new arrays;
    a copy of every cache per token would cost its whole size), and
    (out, cache) is returned."""
    q, k, v = qkv_proj(p, x)                                       # (B,1,H/Kv,hd)
    pos = int(pos)
    dev = x.device
    cos, sin = rope_freqs(torch.tensor([pos], device=dev), q.shape[-1], rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])

    C = cache.k.shape[1]
    slot = pos % C if ring else min(pos, C - 1)
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)

    idx = torch.arange(C, device=dev)
    if ring:
        # entry at slot i holds position: the largest p <= pos with p % C == i
        kv_pos = pos - torch.remainder(slot - idx, C)              # age 0 == current token
        valid = kv_pos >= 0
        if window is not None:
            valid &= (pos - kv_pos) < window
    else:
        valid = idx <= pos
        if window is not None:
            valid &= (pos - idx) < window
    o = plain_attention(q, cache.k, cache.v, mask=valid[None, None, None, None, :])
    return out_proj(p, o), cache
