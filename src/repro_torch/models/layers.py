"""Shared primitives: RMSNorm, LayerNorm, rotary embeddings, initializers.

Counterpart of ``repro/models/layers.py``; same math, same layouts.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, cast back to the input dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary angles -> (cos, sin), each (..., head_dim // 2) f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (float(theta) ** exponent)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


class MetaGenerator:
    """Stands in for a torch.Generator where init must draw nothing: every
    initializer given it returns a tensor of the right shape and dtype on
    the meta device (no storage, no draw)."""
    device = torch.device("meta")


def truncated_normal(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverse CDF of a uniform,
    drawn on the generator's device (a `MetaGenerator` draws nothing)."""
    if generator.device.type == "meta":
        return torch.empty(tuple(shape), device="meta")
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    p = lo + u * (hi - lo)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp_(-2.0, 2.0)


def dense_init(shape: Sequence[int], generator: torch.Generator,
               dtype=torch.float32, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal init with standard deviation `scale`, by default
    1/sqrt(fan-in) (fan-in = product of all but the last dimension, the
    reference's rule)."""
    if scale is None:
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
        return (truncated_normal(shape, generator)
                / math.sqrt(max(fan_in, 1))).to(dtype)
    return (scale * truncated_normal(shape, generator)).to(dtype)


def embed_init(shape: Sequence[int], generator: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
    return (0.02 * truncated_normal(shape, generator)).to(dtype)
