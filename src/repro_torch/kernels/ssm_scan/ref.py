"""Plain PyTorch versions of the ssm_scan kernel: the generalized chunked
SSD scan, its one-token step, and the kernel's own intra-chunk part.

`ssd_chunked` and `ssd_step` are the counterparts of
``repro/models/ssm.py::ssd_chunked`` and ``ssd_step`` (the reference's
``ssm_scan/ref.py`` delegates to them); `ssd_chunk_scan_ref` computes what
the kernel computes (``repro/kernels/ssm_scan/kernel.py``), in the port's
model layout. Per head h:

    S_t = exp(ld_t) * S_{t-1} + k_t (g_t v_t)^T        (state: N x P)
    y_t = q_t^T S_t

evaluated chunk by chunk: the quadratic intra-chunk part, then the state
carried over from the previous chunks. ``repro_torch.models.ssm`` exports
these functions as its own; the wrapper in ``ops.py`` runs them on CPU
tensors, and the chip smoke script holds the kernel against them on the
card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                g: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (B,S,H,P); ld, g: (B,S,H); k, q: (B,S,H,N).

    Returns (y: (B,S,H,P) f32-accumulated in v's dtype, h_final: (B,H,N,P)
    f32). A ragged last chunk is zero-padded (ld = 0, g = 0)."""
    B, S, H, P = v.shape
    N = k.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        v, k, q = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (v, k, q))
        g, ld = (F.pad(a, (0, 0, 0, pad)) for a in (g, ld))
    nc = (S + pad) // Q

    def chunked(a):
        return a.reshape((B, nc, Q) + tuple(a.shape[2:])).transpose(0, 1)

    vf = chunked(v.to(torch.float32) * g.to(torch.float32)[..., None])
    kc = chunked(k.to(torch.float32))
    qc = chunked(q.to(torch.float32))
    cum = torch.cumsum(chunked(ld.to(torch.float32)), dim=2)      # (nc,B,Q,H) inclusive
    tot = cum[:, :, -1, :]                                         # (nc,B,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=v.device))

    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=v.device) if h0 is None
         else h0.to(torch.float32))
    ys = []
    for c in range(nc):
        vj, kj, qj, cumj, totj = vf[c], kc[c], qc[c], cum[c], tot[c]
        qk = torch.einsum("bthn,bshn->btsh", qj, kj)
        # mask BEFORE exp: above-diagonal cum differences are positive and
        # overflow f32 for long chunks (exp(+large) -> inf -> inf*0 = NaN)
        delta = cumj[:, :, None, :] - cumj[:, None, :, :]
        dec = torch.exp(torch.where(tri[None, :, :, None], delta, -torch.inf))
        y_in = torch.einsum("btsh,bshp->bthp", qk * dec, vj)
        q_dec = qj * torch.exp(cumj)[..., None]
        y_st = torch.einsum("bthn,bhnp->bthp", q_dec, h)
        w = torch.exp(totj[:, None, :] - cumj)                     # (B,Q,H)
        h = (torch.exp(totj)[:, :, None, None] * h
             + torch.einsum("bshn,bshp->bhnp", kj * w[..., None], vj))
        ys.append(y_in + y_st)
    y = torch.stack(ys, dim=1).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(v.dtype), h


def ssd_step(h: torch.Tensor, v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor,
             q: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. h: (B,H,N,P); v: (B,H,P); ld, g: (B,H);
    k, q: (B,H,N). Returns (y: (B,H,P) in v's dtype, h_new f32)."""
    hf = h.to(torch.float32)
    a = torch.exp(ld.to(torch.float32))[..., None, None]
    upd = torch.einsum("bhn,bhp->bhnp", k.to(torch.float32),
                       v.to(torch.float32) * g.to(torch.float32)[..., None])
    h_new = a * hf + upd
    y = torch.einsum("bhn,bhnp->bhp", q.to(torch.float32), h_new)
    return y.to(v.dtype), h_new


def ssd_chunk_scan_ref(v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                       g: torch.Tensor, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The intra-chunk part, per chunk of `chunk` positions (a ragged last
    chunk zero-padded): y_intra (B,S,H,P) = tril((q k^T) * exp(cum_i -
    cum_j)) @ (g v), h_add (B,nc,H,N,P) = (k * exp(tot - cum))^T @ (g v),
    cum (B,S,H) the inclusive cumsum of ld within the chunk and tot
    (B,nc,H) its last value; all f32."""
    B, S, H, P = v.shape
    N = k.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunked(a):
        a = F.pad(a.to(torch.float32), (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape((B, nc, chunk) + tuple(a.shape[2:]))

    vf = chunked(v.to(torch.float32) * g.to(torch.float32)[..., None])
    kc, qc = chunked(k), chunked(q)
    cum = torch.cumsum(chunked(ld), dim=2)                         # (B,nc,Q,H)
    tot = cum[:, :, -1]                                            # (B,nc,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=v.device))
    ys, hs = [], []
    for c in range(nc):
        qk = torch.einsum("bthn,bshn->btsh", qc[:, c], kc[:, c])
        delta = cum[:, c, :, None, :] - cum[:, c, None, :, :]
        dec = torch.exp(torch.where(tri[None, :, :, None], delta, -torch.inf))
        ys.append(torch.einsum("btsh,bshp->bthp", qk * dec, vf[:, c]))
        w = torch.exp(tot[:, c, None, :] - cum[:, c])              # (B,Q,H)
        hs.append(torch.einsum("bshn,bshp->bhnp", kc[:, c] * w[..., None], vf[:, c]))
    y = torch.stack(ys, dim=1).reshape(B, nc * chunk, H, P)[:, :S]
    return y, torch.stack(hs, dim=1), cum.reshape(B, nc * chunk, H)[:, :S], tot
