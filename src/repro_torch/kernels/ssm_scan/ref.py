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


def ssd_chunk_scan_bwd_ref(dy: torch.Tensor, dh: torch.Tensor, dcum: torch.Tensor,
                           dtot: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
                           k: torch.Tensor, q: torch.Tensor, g: torch.Tensor, chunk: int
                           ) -> Tuple[torch.Tensor, ...]:
    """The backward of `ssd_chunk_scan_ref`: the cotangents (dy (B,S,H,P),
    dh (B,nc,H,N,P), dcum (B,S,H), dtot (B,nc,H)) of its four outputs to
    those of its inputs, (dv, dld, dk, dq, dg) in the inputs' shapes and
    dtypes (dk and dq dense, also where k and q broadcast). Per chunk, with
    u_j = g_j v_j, L_ij = exp(cum_i - cum_j) for j <= i (0 above the
    diagonal), S_ij = q_i . k_j, w_j = exp(tot - cum_j) and
    A_ij = L_ij S_ij (dy_i . u_j):

        dq_i = sum_j L_ij (dy_i . u_j) k_j
        dk_j = sum_i L_ij (dy_i . u_j) q_i + w_j dh u_j
        du_j = sum_i L_ij S_ij dy_i + w_j dh^T k_j      dv = g du, dg = v . du
        c_i  = dcum_i + sum_j A_ij - sum_i' A_i'i - w_i k_i^T dh u_i
               (the last row also gets dtot + sum_j w_j k_j^T dh u_j)
        dld  = the reverse cumsum of c within the chunk

    A ragged last chunk is zero-padded as in the forward, so its tot is the
    cum of its last valid row and the padded rows add nothing."""
    B, S, H, P = v.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunked(a):
        a = F.pad(a.to(torch.float32), (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape((B, nc, chunk) + tuple(a.shape[2:]))

    vc, gc = chunked(v), chunked(g)
    uf = vc * gc[..., None]
    kc, qc, dyc, dcc = chunked(k), chunked(q), chunked(dy), chunked(dcum)
    cum = torch.cumsum(chunked(ld), dim=2)                         # (B,nc,Q,H)
    tot = cum[:, :, -1]
    dh, dtot = dh.to(torch.float32), dtot.to(torch.float32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=v.device))
    last = (torch.arange(chunk, device=v.device) == chunk - 1).to(torch.float32)
    dus, dks, dqs, cs = [], [], [], []
    for c in range(nc):
        u, kj, qj, dyj, cumj = uf[:, c], kc[:, c], qc[:, c], dyc[:, c], cum[:, c]
        delta = cumj[:, :, None, :] - cumj[:, None, :, :]             # (B,i,j,H)
        L = torch.exp(torch.where(tri[None, :, :, None], delta, -torch.inf))
        Sij = torch.einsum("bihn,bjhn->bijh", qj, kj)
        LD = L * torch.einsum("bihp,bjhp->bijh", dyj, u)
        A = LD * Sij
        w = torch.exp(tot[:, c, None, :] - cumj)                       # (B,Q,H)
        dhu = torch.einsum("bhnp,bjhp->bjhn", dh[:, c], u)             # dh u_j
        wt = w * torch.einsum("bjhn,bjhn->bjh", kj, dhu)               # w_j k_j^T dh u_j
        dqs.append(torch.einsum("bijh,bjhn->bihn", LD, kj))
        dks.append(torch.einsum("bijh,bihn->bjhn", LD, qj) + w[..., None] * dhu)
        dus.append(torch.einsum("bijh,bihp->bjhp", L * Sij, dyj)
                   + w[..., None] * torch.einsum("bhnp,bjhn->bjhp", dh[:, c], kj))
        # tot is the last row's cum: its cotangent joins that row's
        cs.append(dcc[:, c] + A.sum(dim=2) - A.sum(dim=1) - wt
                  + last[None, :, None] * (dtot[:, c] + wt.sum(dim=1))[:, None, :])

    def unchunk(parts):
        x = torch.stack(parts, dim=1)
        return x.reshape((B, nc * chunk) + tuple(x.shape[3:]))[:, :S]

    du = torch.stack(dus, dim=1)                                       # (B,nc,Q,H,P)
    c_all = torch.stack(cs, dim=1)                                     # (B,nc,Q,H)
    dld = torch.flip(torch.cumsum(torch.flip(c_all, (2,)), dim=2), (2,))
    dv = (du * gc[..., None]).reshape(B, nc * chunk, H, P)[:, :S]
    dg = (du * vc).sum(dim=-1).reshape(B, nc * chunk, H)[:, :S]
    return (dv.to(v.dtype), dld.reshape(B, nc * chunk, H)[:, :S].to(ld.dtype),
            unchunk(dks).to(k.dtype), unchunk(dqs).to(q.dtype), dg.to(g.dtype))
