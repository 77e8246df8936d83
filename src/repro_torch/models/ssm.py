"""State-space sequence mixing: the chunked SSD scan and the Mamba2 block.
Counterpart of ``repro/models/ssm.py``; same math, same layouts.

The generalized scan computes, per head h:
    S_t = exp(ld_t) * S_{t-1} + k_t (g_t v_t)^T        (state: N x P)
    y_t = q_t^T S_t
which covers Mamba2 (SSD: k = B_ssm, q = C_ssm shared across heads,
g = dt, ld = dt * A) and the mLSTM (k, q per head, g the input gate, ld the
log forget gate). `ssd_chunked` and `ssd_step` are the plain versions, kept
beside the kernel in ``kernels/ssm_scan/ref.py``; `mamba2_forward` calls
``kernels.ssm_scan.ops.ssd_chunked``, which runs the plain version on a CPU
tensor and the Hopper kernels on a CUDA tensor: the forward kernel, and
under autograd the backward kernel, so the hybrid trains on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssd_chunked, ssd_step
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding import spmd
from repro_torch.sharding.spmd import einsum

__all__ = ["Mamba2Params", "Mamba2State", "causal_conv", "causal_conv_step", "init_mamba2",
           "init_mamba2_state", "mamba2_decode", "mamba2_dims", "mamba2_forward",
           "ssd_chunked", "ssd_step"]


# ---------------------------------------------------------------------------
# causal depthwise conv (mamba2 / xLSTM frontends)
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C); w: (K,C) depthwise. Returns (B,S,C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].to(torch.float32) * w[i].to(torch.float32)
    return out.to(x.dtype)


def causal_conv_step(state: torch.Tensor, x1: torch.Tensor, w: torch.Tensor):
    """state: (B,K-1,C) past inputs; x1: (B,C). Returns (y: (B,C), new_state)."""
    hist = torch.cat([state, x1[:, None]], dim=1)                  # (B,K,C)
    y = einsum("bkc,kc->bc", hist.to(torch.float32),
                     w.to(torch.float32)).to(x1.dtype)
    return y, hist[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
class Mamba2Params(NamedTuple):
    w_z: torch.Tensor        # (d, d_in)
    w_x: torch.Tensor        # (d, d_in)
    w_B: torch.Tensor        # (d, N)
    w_C: torch.Tensor        # (d, N)
    w_dt: torch.Tensor       # (d, H)
    conv: torch.Tensor       # (K, d_in + 2N)
    A_log: torch.Tensor      # (H,) f32
    D: torch.Tensor          # (H,) f32
    dt_bias: torch.Tensor    # (H,) f32
    norm: torch.Tensor       # (d_in,)
    w_out: torch.Tensor      # (d_in, d)


class Mamba2State(NamedTuple):
    h: torch.Tensor          # (B, H, N, P) f32
    conv: torch.Tensor       # (B, K-1, d_in + 2N)


def mamba2_dims(d_model: int, s: SSMConfig):
    d_in = s.expand * d_model
    return d_in, d_in // s.head_dim


def init_mamba2(generator: torch.Generator, d_model: int, s: SSMConfig,
                dtype=torch.float32) -> Mamba2Params:
    """Random weights drawn from `generator` (on its device), with the
    reference's distributions: fan-in truncated normals, the conv at std
    0.5, A = -linspace(1, 16, H), dt_bias = softplus^-1(linspace(1e-3, 0.1,
    H)), D and the norm ones."""
    d_in, H = mamba2_dims(d_model, s)
    dev = generator.device

    def w(*shape, scale=None):
        return dense_init(shape, generator, dtype, scale=scale)

    lin = torch.linspace(1e-3, 1e-1, H, dtype=torch.float64)
    return Mamba2Params(
        w_z=w(d_model, d_in), w_x=w(d_model, d_in),
        w_B=w(d_model, s.d_state), w_C=w(d_model, s.d_state), w_dt=w(d_model, H),
        conv=w(s.d_conv, d_in + 2 * s.d_state, scale=0.5),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        D=torch.ones(H, dtype=torch.float32, device=dev),
        dt_bias=torch.log(torch.expm1(lin)).to(torch.float32).to(dev),
        norm=torch.ones(d_in, dtype=dtype, device=dev),
        w_out=w(d_in, d_model))


def _mamba2_proj(p: Mamba2Params, x: torch.Tensor):
    z = einsum("bsd,de->bse", x, p.w_z)
    xc = einsum("bsd,de->bse", x, p.w_x)
    Bm = einsum("bsd,dn->bsn", x, p.w_B)
    Cm = einsum("bsd,dn->bsn", x, p.w_C)
    dt_raw = einsum("bsd,dh->bsh", x, p.w_dt)
    return z, torch.cat([xc, Bm, Cm], dim=-1), dt_raw


def _gate_out(p: Mamba2Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), p.norm)
    return einsum("bse,ed->bsd", y, p.w_out)


def mamba2_forward(p: Mamba2Params, x: torch.Tensor, s: SSMConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). The SSD scan goes through the kernel's
    entry point (plain version on the CPU, the Hopper kernels forward and
    backward on CUDA); B and C reach it broadcast over the heads as
    stride-0 views, and autograd sums their gradients over the heads."""
    B_, S, d = x.shape
    d_in, H = mamba2_dims(d, s)
    N, P = s.d_state, s.head_dim
    z, xbc, dt_raw = _mamba2_proj(p, x)
    xbc = F.silu(causal_conv(xbc, p.conv).to(torch.float32)).to(x.dtype)
    xc, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)         # (B,S,H)
    ld = dt * -torch.exp(p.A_log)
    v = xc.reshape(B_, S, H, P)

    def scan(v, ld, Bm, Cm, dt):
        Hl = v.shape[2]
        k = Bm[:, :, None, :].expand(v.shape[0], S, Hl, N)
        q = Cm[:, :, None, :].expand(v.shape[0], S, Hl, N)
        return ssm_ops.ssd_chunked(v, ld, k, q, dt, chunk=s.chunk)[0]
    y = spmd.on_heads(scan, (v, ld, Bm, Cm, dt), ((0, 2), (0, 2), (0, None), (0, None), (0, 2)),
                 (0, 2), H)
    y = y + (p.D[None, None, :, None] * v.to(torch.float32)).to(y.dtype)
    return _gate_out(p, spmd.keep_grad_layout(y.reshape(B_, S, d_in)), z)


def init_mamba2_state(batch: int, d_model: int, s: SSMConfig, dtype=torch.bfloat16,
                      device=None) -> Mamba2State:
    """A zero state on `device` (CUDA when None)."""
    d_in, H = mamba2_dims(d_model, s)
    device = resolve_device(device)
    return Mamba2State(
        h=torch.zeros((batch, H, s.d_state, s.head_dim), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.d_conv - 1, d_in + 2 * s.d_state), dtype=dtype,
                         device=device))


def mamba2_decode(p: Mamba2Params, x: torch.Tensor, state: Mamba2State,
                  s: SSMConfig) -> Tuple[torch.Tensor, Mamba2State]:
    """x: (B, 1, d). Returns (out (B,1,d), new_state)."""
    B_, _, d = x.shape
    d_in, H = mamba2_dims(d, s)
    N, P = s.d_state, s.head_dim
    z, xbc, dt_raw = _mamba2_proj(p, x)
    conv_out, new_conv = causal_conv_step(state.conv.to(xbc.dtype), xbc[:, 0], p.conv)
    xbc1 = F.silu(conv_out.to(torch.float32)).to(x.dtype)         # (B,C)
    xc, Bm, Cm = torch.split(xbc1, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p.dt_bias)  # (B,H)
    ld = dt * -torch.exp(p.A_log)
    v = xc.reshape(B_, H, P)

    def step(h, v, ld, Bm, Cm, dt):
        Hl = v.shape[1]
        return ssd_step(h, v, ld, Bm[:, None, :].expand(v.shape[0], Hl, N),
                        Cm[:, None, :].expand(v.shape[0], Hl, N), dt)
    y, h_new = spmd.on_heads(step, (state.h, v, ld, Bm, Cm, dt),
                        ((0, 1),) * 3 + ((0, None),) * 2 + ((0, 1),), ((0, 1), (0, 1)), H)
    y = y + (p.D[None, :, None] * v.to(torch.float32)).to(y.dtype)
    out = _gate_out(p, y.reshape(B_, 1, d_in), z)
    return out, Mamba2State(h_new, new_conv.to(state.conv.dtype))
