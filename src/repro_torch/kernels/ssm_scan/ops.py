"""Entry point of the ssm_scan kernel: the chunked SSD scan with the
model's contract.

    y, h_final = ssd_chunked(v, ld, k, q, g, chunk=Q, h0=None)

The counterpart of ``repro/kernels/ssm_scan/ops.py`` (``ssd_chunked_pallas``,
which it extends by `h0`), and a drop-in for ``models.ssm.ssd_chunked``,
which `mamba2_forward` calls through this module. The backend follows the
tensor: a CPU tensor runs the plain version from ``ref.py``; a CUDA tensor
launches the kernel from ``kernel.py`` for the intra-chunk part, and a
failed build or launch raises. There is no fallback from one to the other.

On CUDA the kernel gives y_intra, h_add, cum and tot per chunk;
`combine_chunks` then runs the recurrence between chunks (a loop of nc
(B, H, N, P) updates) and the product of the decayed queries with the
carried states (one batched matmul) as torch ops, as the reference leaves
them to XLA. The
kernel has no backward (the reference has none either), so a CUDA call
that would need one raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_scan_cuda
from repro_torch.kernels.ssm_scan.ref import ssd_chunked as ssd_chunked_ref


def ssd_chunked(v: torch.Tensor, ld: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                g: torch.Tensor, *, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (B,S,H,P); ld, g: (B,S,H); k, q: (B,S,H,N); h0: None or (B,H,N,P).
    Returns (y (B,S,H,P) in v's dtype, h_final (B,H,N,P) f32)."""
    if v.device.type == "cpu":
        return ssd_chunked_ref(v, ld, k, q, g, chunk=chunk, h0=h0)
    if v.device.type != "cuda":
        raise ValueError(f"ssd_chunked: tensors on {v.device} are not supported "
                         "(cpu runs the plain version, cuda the kernel)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (v, ld, k, q, g) + (() if h0 is None else (h0,))):
        raise NotImplementedError(
            "ssd_chunk_scan has no backward on CUDA (nor in the reference); training "
            "through it waits for the slice that trains the hybrid on the card")
    Q = min(chunk, v.shape[1])
    parts = ssd_chunk_scan_cuda(v, ld.to(torch.float32), k, q, g.to(torch.float32), Q)
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
