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

On a mesh (DTensor activations and weights) the projections shard by
their letters (`sharding.spmd.einsum`) and the attention itself runs on
each rank's local heads with the sequence whole (`_on_local_heads`): the
flash kernel and the blockwise loop see plain tensors. Where the kv heads
do not split over "model" (Kv 8 over 16 ranks, MQA's Kv 1), every rank
holds them all and takes the ones its query heads read. Decode writes the
token's k and v on the rank that holds the slot and attends to the cache
where it lies (`_attend_cached`): a cache whose sequence axis is split (a
batch of one) combines the ranks' partial softmaxes, as flash decoding
does, so the cache is never gathered.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, rope_freqs
from repro_torch.sharding import spmd
from repro_torch.sharding.spmd import einsum

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
    q = einsum("bsd,dhk->bshk", x, p.wq)
    k = einsum("bsd,dhk->bshk", x, p.wk)
    v = einsum("bsd,dhk->bshk", x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def out_proj(p: AttnParams, o: torch.Tensor) -> torch.Tensor:
    return einsum("bshk,hkd->bsd", o, p.wo)


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
        s = einsum("bqkgh,bckh->bqkgc", qg, kj) * scale
        mask = _kv_mask(q_positions, pj, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        o = einsum("bqkgc,bckh->bqkgh", p.to(q.dtype).to(torch.float32),
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
    s = einsum("bqkgh,bckh->bqkgc", qg, k.to(torch.float32)) * hd ** -0.5
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = einsum("bqkgc,bckh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------
def attention_forward(p: AttnParams, x: torch.Tensor, *, positions: torch.Tensor,
                      rope_theta: float, causal: bool = True, window: Optional[int] = None,
                      kv_chunk: int = 1024, backend: str = "jnp") -> torch.Tensor:
    """backend: "jnp" (blockwise online softmax, plain torch ops) or
    "pallas" (the flash kernel's entry point)."""
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown attention backend {backend!r} (expected 'jnp' or 'pallas')")
    q, k, v = qkv_proj(p, x)
    cos, sin = rope_freqs(positions, q.shape[-1], rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])

    def core(q, k, v, positions):
        if backend == "pallas":
            return flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        return blockwise_attention(q, k, v, q_positions=positions, kv_positions=positions,
                                   causal=causal, window=window, kv_chunk=kv_chunk)
    return out_proj(p, _on_local_heads(core, q, k, v, positions))


def _on_local_heads(fn, q, kc, vc, *rest):
    """fn(q, kc, vc, *rest) on plain tensors (kc, vc: the keys and values):
    as it stands off a mesh; on a mesh on each rank's batch rows and query
    heads, with the kv heads those query heads read (`rest` replicated)."""
    mesh = spmd.mesh_of(q, kc, vc)
    if mesh is None:
        return fn(q, kc, vc, *rest)
    B, H, Kv = q.shape[0], q.shape[2], kc.shape[2]
    G = H // Kv
    md = spmd.model_dim(mesh)
    ms = 1 if md is None else mesh.size(md)
    batch = spmd.shards(mesh, B, spmd.data_dims(mesh))
    hl = H // ms
    heads = H % ms == 0 and (hl % G == 0 or G % hl == 0)
    kv_split = heads and Kv % ms == 0
    kv_dims = (0, 2) if kv_split else (0, None)

    def local(q, k, v, *rest):
        if heads and not kv_split:                 # the kv heads my query heads read
            lo = mesh.get_local_rank(md) * hl
            k, v = k[:, :, lo // G:(lo + hl - 1) // G + 1], v[:, :, lo // G:(lo + hl - 1) // G + 1]
        return fn(q, k, v, *rest)
    return spmd.local_map(local, (q, kc, vc) + rest,
                          ((0, 2), kv_dims, kv_dims) + (None,) * len(rest), (0, 2), mesh,
                          batch=batch, heads=heads)


def encoder_attention(p: AttnParams, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional, no RoPE (the whisper encoder adds learned absolute
    positions)."""
    q, k, v = qkv_proj(p, x)
    return out_proj(p, _on_local_heads(plain_attention, q, k, v))


def cross_attention(p: AttnParams, x: torch.Tensor, enc_k: torch.Tensor,
                    enc_v: torch.Tensor) -> torch.Tensor:
    """x's queries against the encoder's kc and vc (`cross_kv`), no
    mask."""
    q = einsum("bsd,dhk->bshk", x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    return out_proj(p, _attend_cached(q, enc_k, enc_v, None))


def cross_kv(p: AttnParams, enc_out: torch.Tensor):
    """The kc and vc (B, S_enc, Kv, hd) of the encoder's output."""
    k = einsum("bsd,dhk->bshk", enc_out, p.wk)
    v = einsum("bsd,dhk->bshk", enc_out, p.wv)
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
    spmd.write_slot(cache.k, 1, slot, k[:, 0].to(cache.k.dtype))
    spmd.write_slot(cache.v, 1, slot, v[:, 0].to(cache.v.dtype))

    def valid(idx):
        if ring:
            # entry at slot i holds position: the largest p <= pos with p % C == i
            kv_pos = pos - torch.remainder(slot - idx, C)          # age 0 == current token
            ok = kv_pos >= 0
            if window is not None:
                ok &= (pos - kv_pos) < window
        else:
            ok = idx <= pos
            if window is not None:
                ok &= (pos - idx) < window
        return ok[None, None, None, None, :]
    return out_proj(p, _attend_cached(q, cache.k, cache.v, valid)), cache


def _attend_cached(q, kc, vc, mask_of):
    """plain_attention(q, kc, vc, mask_of(slot indices)) against a cache's
    keys and values (mask_of None: every slot). Off a mesh, or on one
    where the cache is whole on every rank but for its batch and heads,
    each rank attends to its own pieces; where the cache's sequence axis
    (or head_dim, for MQA) is split, the ranks' partial scores and
    softmaxes are combined by all-reduces over those mesh dims."""
    mesh = spmd.mesh_of(kc)
    C = kc.shape[1]
    if mesh is None:
        return plain_attention(q, kc, vc, None if mask_of is None
                               else mask_of(torch.arange(C, device=q.device)))
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def along(d):
        return [m for m, p in enumerate(kc.placements) if p.is_shard() and p.dim == d]
    c_dims, hd_dims = along(1), along(3)
    kc = spmd.reduced(kc)
    qpl = [Shard(p.dim) if p.is_shard() and p.dim != 1 else Replicate() for p in kc.placements]
    ql = spmd.reduced(spmd.as_dtensor(mesh, q)).redistribute(mesh, qpl).to_local()
    kl, vl = kc.to_local(), spmd.reduced(vc).redistribute(mesh, kc.placements).to_local()
    c_loc, c0 = kl.shape[1], 0
    for m in c_dims:
        c0 = c0 * mesh.size(m) + mesh.get_local_rank(m)
    idx = torch.arange(c_loc, device=kl.device) + c0 * c_loc
    mask = None if mask_of is None else mask_of(idx)
    if not c_dims and not hd_dims:
        o = plain_attention(ql, kl, vl, mask=mask)
    else:
        def total(t, op, dims):
            for m in dims:
                t = funcol.all_reduce(t, op, (mesh, m))
            return t
        B, Sq, Hl, hd = ql.shape
        Kvl = kl.shape[2]
        qg = ql.reshape(B, Sq, Kvl, Hl // Kvl, hd).to(torch.float32)
        s = total(torch.einsum("bqkgh,bckh->bqkgc", qg, kl.to(torch.float32)), "sum", hd_dims)
        s = s * (hd * mesh.size(hd_dims[0]) if hd_dims else hd) ** -0.5
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m = total(s.amax(dim=-1, keepdim=True), "max", c_dims)
        e = torch.exp(s - m)
        den = total(e.sum(dim=-1, keepdim=True), "sum", c_dims)
        o = total(torch.einsum("bqkgc,bckh->bqkgh", e, vl.to(torch.float32)), "sum", c_dims)
        o = (o / den).reshape(B, Sq, Hl, hd).to(ql.dtype)
    return DTensor.from_local(o, mesh, qpl, run_check=False)
