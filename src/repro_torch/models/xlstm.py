"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, strictly sequential). Counterpart of
``repro/models/xlstm.py``; same math, same layouts.

The mLSTM maps onto the generalized SSD scan of ``models/ssm.py``:
    state C_t = f_t C_{t-1} + i_t k_t v_t^T   ->   ld = log f, g = i, k/q per head
with a normalizer obtained by augmenting v with a ones-channel, and
`y = num / max(|den|, 1)`. `mlstm_forward` calls
``kernels.ssm_scan.ops.ssd_chunked``, as `mamba2_forward` does: the plain
scan on a CPU tensor, the Hopper kernels (the wide-head variant: N = dm /
H, P = N + 1) forward and backward on a CUDA tensor. `mlstm_decode` takes
the plain one-token step.

As in the reference, the gates are *bounded* — f = sigmoid(f_raw), i =
sigmoid(i_raw) — instead of the paper's exp input gate and running-max
stabilizer; the normalizer makes the block equivalent up to the
stabilizer. The sLSTM's recurrence is a Python loop over the positions
(the reference's `lax.scan`); it has no kernel in either package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.ssm import causal_conv, causal_conv_step, ssd_step
from repro_torch.sharding import spmd
from repro_torch.sharding.spmd import einsum, on_heads

__all__ = ["MLSTMParams", "MLSTMState", "SLSTMParams", "SLSTMState", "init_mlstm",
           "init_mlstm_state", "init_slstm", "init_slstm_state", "mlstm_decode", "mlstm_dims",
           "mlstm_forward", "slstm_decode", "slstm_dims", "slstm_forward"]


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------
class MLSTMParams(NamedTuple):
    w_up: torch.Tensor       # (d, dm)
    w_z: torch.Tensor        # (d, dm)
    conv: torch.Tensor       # (K, dm)
    w_q: torch.Tensor        # (dm, H, N)
    w_k: torch.Tensor        # (dm, H, N)
    w_v: torch.Tensor        # (dm, H, N)   (P == N == dm // H)
    w_i: torch.Tensor        # (dm, H)
    w_f: torch.Tensor        # (dm, H)
    b_f: torch.Tensor        # (H,) f32 — init positive: remember by default
    norm: torch.Tensor       # (dm,)
    w_down: torch.Tensor     # (dm, d)


class MLSTMState(NamedTuple):
    h: torch.Tensor          # (B, H, N, P+1) f32 — last channel = normalizer
    conv: torch.Tensor       # (B, K-1, dm)


def mlstm_dims(cfg: ModelConfig):
    x = cfg.xlstm or XLSTMConfig()
    dm = int(cfg.d_model * x.mlstm_proj_factor)
    H = cfg.n_heads
    return dm, H, dm // H


def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> MLSTMParams:
    """Random weights drawn from `generator` (on its device) with the
    reference's distributions: fan-in truncated normals, the conv at std
    0.5, b_f = 3 and the norm ones."""
    x = cfg.xlstm or XLSTMConfig()
    dm, H, N = mlstm_dims(cfg)
    dev = generator.device

    def w(*shape, scale=None):
        return dense_init(shape, generator, dtype, scale=scale)

    return MLSTMParams(
        w_up=w(cfg.d_model, dm), w_z=w(cfg.d_model, dm),
        conv=w(x.conv_kernel, dm, scale=0.5),
        w_q=w(dm, H, N), w_k=w(dm, H, N), w_v=w(dm, H, N),
        w_i=w(dm, H), w_f=w(dm, H),
        b_f=torch.full((H,), 3.0, dtype=torch.float32, device=dev),
        norm=torch.ones(dm, dtype=dtype, device=dev),
        w_down=w(dm, cfg.d_model))


def _mlstm_qkvif(p: MLSTMParams, u: torch.Tensor, uc: torch.Tensor):
    q = einsum("bse,ehn->bshn", uc, p.w_q)
    k = einsum("bse,ehn->bshn", uc, p.w_k)
    v = einsum("bse,ehn->bshn", u, p.w_v)
    i_raw = einsum("bse,eh->bsh", uc, p.w_i).to(torch.float32)
    f_raw = einsum("bse,eh->bsh", uc, p.w_f).to(torch.float32) + p.b_f
    i_g = torch.sigmoid(i_raw)
    log_f = -F.softplus(-f_raw)                   # log sigmoid(f_raw)
    return q, k, v, i_g, log_f


def _mlstm_out(p: MLSTMParams, y_aug: torch.Tensor, z: torch.Tensor, N: int,
               dtype) -> torch.Tensor:
    """num / max(|den|, 1), the norm, the output gate and the down
    projection; y_aug (B, S, H, N + 1)."""
    B, S = y_aug.shape[:2]
    num, den = y_aug[..., :N].to(torch.float32), y_aug[..., N].to(torch.float32)
    y = (num / torch.clamp(den.abs(), min=1.0)[..., None]).reshape(B, S, -1).to(dtype)
    y = rms_norm(spmd.keep_grad_layout(y), p.norm) * F.silu(z.to(torch.float32)).to(dtype)
    return einsum("bse,ed->bsd", y, p.w_down)


def mlstm_forward(p: MLSTMParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). The scan goes through the kernel's entry
    point with N = dm / H and P = N + 1 (v and its ones column)."""
    S = x.shape[1]
    dm, H, N = mlstm_dims(cfg)
    u = einsum("bsd,de->bse", x, p.w_up)
    z = einsum("bsd,de->bse", x, p.w_z)
    uc = F.silu(causal_conv(u, p.conv).to(torch.float32)).to(x.dtype)
    q, k, v, i_g, log_f = _mlstm_qkvif(p, u, uc)
    v_aug = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)],
                      dim=-1)                                         # (B,S,H,N+1)
    chunk = min(256, max(S, 8))
    y_aug = on_heads(lambda *a: ssm_ops.ssd_chunked(*a, chunk=chunk)[0],
                     (v_aug, log_f, k, q, i_g), ((0, 2),) * 5, (0, 2), H)
    return _mlstm_out(p, y_aug, z, N, x.dtype)


def init_mlstm_state(batch: int, cfg: ModelConfig, dtype=torch.bfloat16,
                     device=None) -> MLSTMState:
    """A zero state on `device` (CUDA when None)."""
    x = cfg.xlstm or XLSTMConfig()
    dm, H, N = mlstm_dims(cfg)
    device = resolve_device(device)
    return MLSTMState(
        h=torch.zeros((batch, H, N, N + 1), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, x.conv_kernel - 1, dm), dtype=dtype, device=device))


def mlstm_decode(p: MLSTMParams, x: torch.Tensor, state: MLSTMState,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, 1, d). Returns (out (B, 1, d), new_state)."""
    dm, H, N = mlstm_dims(cfg)
    u = einsum("bsd,de->bse", x, p.w_up)
    z = einsum("bsd,de->bse", x, p.w_z)
    c_out, new_conv = causal_conv_step(state.conv.to(u.dtype), u[:, 0], p.conv)
    uc = F.silu(c_out.to(torch.float32)).to(x.dtype)[:, None]
    q, k, v, i_g, log_f = _mlstm_qkvif(p, u, uc)
    v_aug = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)],
                      dim=-1)
    y_aug, h_new = on_heads(ssd_step, (state.h, v_aug[:, 0], log_f[:, 0], k[:, 0], q[:, 0],
                                       i_g[:, 0]), ((0, 1),) * 6, ((0, 1), (0, 1)), H)
    out = _mlstm_out(p, y_aug[:, None], z, N, x.dtype)
    return out, MLSTMState(h_new, new_conv.to(state.conv.dtype))


# ---------------------------------------------------------------------------
# sLSTM block — strictly sequential exponential-gated scalar memory
# ---------------------------------------------------------------------------
class SLSTMParams(NamedTuple):
    w_in: torch.Tensor       # (d, H, hd, 4)  input weights for i, f, z, o
    r: torch.Tensor          # (H, hd, hd, 4) per-head recurrent weights
    b: torch.Tensor          # (H, hd, 4) f32
    norm: torch.Tensor       # (d,)
    w_up: torch.Tensor       # (d, 2*fs)
    w_down: torch.Tensor     # (fs, d)


class SLSTMState(NamedTuple):
    c: torch.Tensor          # (B, H, hd) f32
    n: torch.Tensor
    hst: torch.Tensor
    m: torch.Tensor


def slstm_dims(cfg: ModelConfig):
    x = cfg.xlstm or XLSTMConfig()
    H = cfg.n_heads
    return H, cfg.d_model // H, int(cfg.d_model * x.slstm_proj_factor)


def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> SLSTMParams:
    """Random weights from `generator` with the reference's distributions
    (the recurrent weights at std 0.3; the f-gate bias 3.0, the others 0)."""
    H, hd, fs = slstm_dims(cfg)
    dev = generator.device
    b = torch.zeros((H, hd, 4), dtype=torch.float32, device=dev)
    b[..., 1] = 3.0                                   # f-bias > 0
    return SLSTMParams(
        w_in=dense_init((cfg.d_model, H, hd, 4), generator, dtype),
        r=dense_init((H, hd, hd, 4), generator, dtype, scale=0.3),
        b=b,
        norm=torch.ones(cfg.d_model, dtype=dtype, device=dev),
        w_up=dense_init((cfg.d_model, 2 * fs), generator, dtype),
        w_down=dense_init((fs, cfg.d_model), generator, dtype))


def _slstm_cell(p: SLSTMParams, zin: torch.Tensor,
                st: SLSTMState) -> Tuple[SLSTMState, torch.Tensor]:
    """zin: (B, H, hd, 4) pre-activations from the input; the recurrent
    part is added here."""
    rec = einsum("bhd,hdkg->bhkg", st.hst.to(torch.float32), p.r.to(torch.float32))
    pre = zin.to(torch.float32) + rec + p.b
    i_raw, f_raw, z_raw, o_raw = pre.unbind(-1)
    log_f = -F.softplus(-f_raw)                   # log sigmoid — stabilized f
    m_new = torch.maximum(log_f + st.m, i_raw)
    i_t = torch.exp(i_raw - m_new)
    f_t = torch.exp(log_f + st.m - m_new)
    z_t = torch.tanh(z_raw)
    o_t = torch.sigmoid(o_raw)
    c_new = f_t * st.c + i_t * z_t
    n_new = f_t * st.n + i_t
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c_new, n_new, h_new, m_new), h_new


def _slstm_out(p: SLSTMParams, y: torch.Tensor, dtype) -> torch.Tensor:
    y = rms_norm(y, p.norm)
    up = einsum("bsd,df->bsf", y, p.w_up)
    a, g = torch.chunk(up, 2, dim=-1)
    act = F.gelu(a.to(torch.float32), approximate="tanh").to(dtype)
    return einsum("bsf,fd->bsd", act * g, p.w_down)


def slstm_forward(p: SLSTMParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the cell over the positions in order."""
    B, S, d = x.shape
    zin = einsum("bsd,dhkg->bshkg", x, p.w_in)

    def scan(zin, r, b):
        # on a mesh each rank runs the loop over its batch rows as plain
        # tensors: tens of ops a position, too many to dispatch as DTensors
        pl = p._replace(r=r, b=b)
        st = init_slstm_state(zin.shape[0], cfg, device=zin.device)
        hs = []
        for t in range(S):
            st, h = _slstm_cell(pl, zin[:, t], st)
            hs.append(h)
        return torch.stack(hs, dim=1).reshape(zin.shape[0], S, d).to(x.dtype)
    y = on_heads(scan, (zin, p.r, p.b), ((0, None), (None, None), (None, None)), (0, None), 1)
    return _slstm_out(p, y, x.dtype)


def init_slstm_state(batch: int, cfg: ModelConfig, device=None) -> SLSTMState:
    """A zero state (m at -1e30) on `device` (CUDA when None)."""
    H, hd, _ = slstm_dims(cfg)
    device = resolve_device(device)
    z = torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, H, hd), -1e30, dtype=torch.float32,
                                          device=device))


def slstm_decode(p: SLSTMParams, x: torch.Tensor, st: SLSTMState,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, SLSTMState]:
    """x: (B, 1, d). Returns (out (B, 1, d), new_state)."""
    B, _, d = x.shape
    zin = einsum("bsd,dhkg->bshkg", x, p.w_in)[:, 0]
    st2, h = _slstm_cell(p, zin, st)
    return _slstm_out(p, h.reshape(B, 1, d).to(x.dtype), x.dtype), st2
