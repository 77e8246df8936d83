"""Entry point of the flash_attention kernel: GQA attention in the model
layout.

    o = flash_attention(q, k, v, causal=True, window=None)

The counterpart of ``repro/kernels/flash_attention/ops.py``. The backend
follows the tensor: a CPU tensor runs the plain version from ``ref.py``; a
CUDA tensor launches the kernel from ``kernel.py``, and a failed build or
launch raises; a meta tensor runs the kernel op's fake (its output's
shape). There is no fallback from one to the other.

Unlike the TPU wrapper, nothing is repeated, transposed or padded here:
the kernel reads kv head h // (H / Kv) through the model layout's strides,
takes hd as it is and masks the ragged tails. The kernel has no backward
(the reference has none either), so a CUDA call that would need one
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, Kv, hd) with Kv dividing H.
    Returns (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type in ("cuda", "meta"):          # meta: the kernel op's fake (shapes)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention has no backward on CUDA (nor in the reference); train "
                "with attn_backend 'jnp', as the reference does")
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: tensors on {q.device} are not supported "
                     "(cpu runs the plain version, cuda the kernel, meta its fake)")
