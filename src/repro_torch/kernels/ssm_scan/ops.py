"""Entry point of the ssm_scan kernel: the chunked SSD scan with the
model's contract.

    y, h_final = ssd_chunked(v, ld, k, q, g, chunk=Q, h0=None)

The counterpart of ``repro/kernels/ssm_scan/ops.py`` (``ssd_chunked_pallas``,
which it extends by `h0`), and a drop-in for ``models.ssm.ssd_chunked``,
which `mamba2_forward` calls through this module. The backend follows the
tensor: a CPU tensor runs the plain whole scan from ``ref.py``; a CUDA
tensor runs the intra-chunk part through `SSDChunkScan`, whose forward and
backward launch the kernels of ``kernel.py``, and a failed build or launch
raises. There is no fallback from one to the other.

On CUDA the kernel gives y_intra, h_add, cum and tot per chunk;
`combine_chunks` then runs the recurrence between chunks (a loop of nc
(B, H, N, P) updates) and the product of the decayed queries with the
carried states (one batched matmul) as torch ops, as the reference leaves
them to XLA. Autograd differentiates those ops as they stand, and
`SSDChunkScan.backward` turns the cotangents of the four parts into those
of (v, ld, k, q, g) with the backward kernel; so the hybrid trains on the
card, as the reference's plain scan trains under ``jax.grad``. A meta
tensor takes the CUDA route through the kernels' fakes (shapes only), so
a step traced on the meta device counts the kernels as the card runs them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_scan_bwd_cuda, ssd_chunk_scan_cuda
from repro_torch.kernels.ssm_scan.ref import (ssd_chunk_scan_bwd_ref, ssd_chunk_scan_ref,
                                              ssd_chunked as ssd_chunked_ref)


def _backend(fn_cpu, fn_cuda, t: torch.Tensor, what: str):
    """The plain version on the CPU; the kernel's custom op on CUDA, and on
    the meta device, where its fake gives the shapes."""
    if t.device.type == "cpu":
        return fn_cpu
    if t.device.type in ("cuda", "meta"):
        return fn_cuda
    raise ValueError(f"{what}: tensors on {t.device} are not supported "
                     "(cpu runs the plain version, cuda the kernel, meta its fake)")


def _fold(info, in_dims, args):
    """torch.func.vmap's mapped axis folded into the batch axis: each
    tensor of `args` (its mapped axis at in_dims[i], or None for an
    unmapped one, which is expanded) becomes (n * B, ...)."""
    n = info.batch_size
    out = []
    for x, d in zip(args, in_dims):
        x = x.unsqueeze(0).expand((n,) + tuple(x.shape)) if d is None else x.movedim(d, 0)
        out.append(x.reshape((-1,) + tuple(x.shape[2:])))
    return out


def _unfold(n: int, outs):
    return tuple(o.reshape((n, -1) + tuple(o.shape[1:])) for o in outs), (0,) * len(outs)


class SSDChunkScan(torch.autograd.Function):
    """The intra-chunk SSD scan as a differentiable op:

        y_intra, h_add, cum, tot = SSDChunkScan.apply(v, ld, k, q, g, chunk)

    (shapes as ``kernel.ssd_chunk_scan_cuda``; ld and g f32). Forward and
    backward follow the tensor: on the CPU the plain bodies
    (``ref.ssd_chunk_scan_ref`` and ``ref.ssd_chunk_scan_bwd_ref``), on
    CUDA the forward kernel and the backward kernel, or a raise. The
    backward returns dense dk and dq; where k and q are stride-0 views
    over the heads (Mamba2's B and C), `expand`'s own backward sums them.
    The saved k and q stay those views. Under ``torch.func.vmap`` the
    mapped axis is folded into the batch axis, both ways, so
    ``vmap(grad(...))`` runs the same kernels once over the folded batch."""

    @staticmethod
    def forward(v, ld, k, q, g, chunk):
        fn = _backend(ssd_chunk_scan_ref, ssd_chunk_scan_cuda, v, "SSDChunkScan")
        return fn(v, ld, k, q, g, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, ld, k, q, g, chunk = inputs
        ctx.save_for_backward(v, ld, k, q, g)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dh, dcum, dtot):
        v, ld, k, q, g = ctx.saved_tensors
        grads = _SSDChunkScanBwd.apply(dy, dh, dcum, dtot, v, ld, k, q, g, ctx.chunk)
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, v, ld, k, q, g, chunk):
        outs = SSDChunkScan.apply(*_fold(info, in_dims[:5], (v, ld, k, q, g)), chunk)
        return _unfold(info.batch_size, outs)


class _SSDChunkScanBwd(torch.autograd.Function):
    """SSDChunkScan's backward as an op of its own, so that torch.func can
    map it (its vmap rule folds the mapped axis as SSDChunkScan's does);
    it has no backward itself (no second derivative)."""

    @staticmethod
    def forward(dy, dh, dcum, dtot, v, ld, k, q, g, chunk):
        fn = _backend(ssd_chunk_scan_bwd_ref, ssd_chunk_scan_bwd_cuda, v, "SSDChunkScan.backward")
        return fn(dy, dh, dcum, dtot, v, ld, k, q, g, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the SSD chunk scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, dy, dh, dcum, dtot, v, ld, k, q, g, chunk):
        outs = _SSDChunkScanBwd.apply(
            *_fold(info, in_dims[:9], (dy, dh, dcum, dtot, v, ld, k, q, g)), chunk)
        return _unfold(info.batch_size, outs)


def ssd_chunked(v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                g: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (B,S,H,P); ld, g: (B,S,H); k, q: (B,S,H,N); h0: None or (B,H,N,P).
    Returns (y (B,S,H,P) in v's dtype, h_final (B,H,N,P) f32)."""
    if v.device.type == "cpu":
        return ssd_chunked_ref(v, ld, k, q, g, chunk=chunk, h0=h0)
    if v.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunked: tensors on {v.device} are not supported "
                         "(cpu runs the plain version, cuda the kernel, meta its fake)")
    Q = min(chunk, v.shape[1])
    parts = SSDChunkScan.apply(v, ld.to(torch.float32), k, q, g.to(torch.float32), Q)
    y, h = combine_chunks(*parts, q, Q, h0)
    return y.to(v.dtype), h


def combine_chunks(y_intra: torch.Tensor, h_add: torch.Tensor, cum: torch.Tensor,
                   tot: torch.Tensor, q: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan from the kernel's per-chunk parts (y_intra (B,S,H,P), h_add
    (B,nc,H,N,P), cum (B,S,H), tot (B,nc,H)) and the queries q (B,S,H,N):
    the state entering chunk c is h_c = exp(tot_{c-1}) h_{c-1} + h_add_{c-1}
    from h_0 = h0 (zeros when None), and y = y_intra + (q * exp(cum)) @ h_c.
    Returns (y f32, the final state)."""
    B, S, H, P = y_intra.shape
    nc, N = h_add.shape[1], h_add.shape[3]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device) if h0 is None
         else h0.to(torch.float32))
    decay = torch.exp(tot)[..., None, None]                        # (B,nc,H,1,1)
    h_prev = torch.empty_like(h_add)                               # state entering chunk c
    for c in range(nc):
        h_prev[:, c] = h
        h = decay[:, c] * h + h_add[:, c]
    pad = nc * chunk - S
    q_dec = F.pad(q.to(torch.float32) * torch.exp(cum)[..., None], (0, 0, 0, 0, 0, pad))
    y_st = torch.einsum("bcqhn,bchnp->bcqhp", q_dec.reshape(B, nc, chunk, H, N), h_prev)
    return y_intra + y_st.reshape(B, nc * chunk, H, P)[:, :S], h
