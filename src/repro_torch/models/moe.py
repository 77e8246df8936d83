"""Mixture-of-Experts with grouped capacity dispatch. Counterpart of
``repro/models/moe.py``; same math, same casts.

Two dispatch modes:
  'onehot'  — grouped one-hot capacity einsum: the dispatch and combine
              tensors in bf16, as the reference has them, so x reaches the
              experts rounded to bf16 and the combine weights are rounded to
              bf16; tokens past an expert's capacity in their group drop.
  'ragged'  — a stable sort of the (token, choice) pairs by expert, then one
              product per expert over its contiguous rows (the reference's
              `jax.lax.ragged_dot`, which no Pallas kernel computes), no
              capacity drop. The group sizes are read on the host. Like
              the reference's, it has no batching rule: under
              ``torch.func.vmap`` it raises NotImplementedError.

The router's Switch-style load-balance loss is returned so the trainer can
add `load_balance_coef * aux`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding import spmd
from repro_torch.sharding.spmd import einsum

__all__ = ["MoEParams", "init_moe", "moe_forward", "moe_forward_onehot", "moe_forward_ragged"]


class MoEParams(NamedTuple):
    router: torch.Tensor     # (d, E) f32
    w_gate: torch.Tensor     # (E, d, f)
    w_up: torch.Tensor       # (E, d, f)
    w_down: torch.Tensor     # (E, f, d)


def init_moe(generator: torch.Generator, d_model: int, m: MoEConfig,
             dtype=torch.float32) -> MoEParams:
    """Fan-in truncated normals from `generator`; the router in f32."""
    E, f = m.n_experts, m.d_expert
    return MoEParams(dense_init((d_model, E), generator, torch.float32),
                     dense_init((E, d_model, f), generator, dtype),
                     dense_init((E, d_model, f), generator, dtype),
                     dense_init((E, f, d_model), generator, dtype))


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros (and,
    unlike F.one_hot, this reads no value on the host, so it maps under
    vmap)."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _router(p: MoEParams, x: torch.Tensor, m: MoEConfig):
    """x: (T, d) -> top-k weights (T, k) f32, indices (T, k), aux loss."""
    logits = einsum("td,de->te", x.to(torch.float32), p.router)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load balance: E * sum_e fraction_e * mean_prob_e
    E = m.n_experts
    frac = _one_hot(idx[:, 0], E, torch.float32).mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return w, idx, aux


def _expert_ffn(p: MoEParams, xe: torch.Tensor) -> torch.Tensor:
    """xe: (G, E, C, d) -> (G, E, C, d); SwiGLU per expert."""
    gate = einsum("gecd,edf->gecf", xe, p.w_gate)
    up = einsum("gecd,edf->gecf", xe, p.w_up)
    return einsum("gecf,efd->gecd", F.silu(gate) * up, p.w_down)


def moe_forward_onehot(p: MoEParams, x: torch.Tensor, m: MoEConfig, *,
                       group_tokens: int = 512,
                       capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Grouped capacity dispatch. Returns (y, aux)."""
    B, S, d = x.shape
    T = B * S
    t = min(group_tokens, T)
    if T % t:
        raise ValueError(f"{T} tokens do not split into groups of {t}")
    G = T // t
    E, k = m.n_experts, m.top_k
    cap = max(int(t * k / E * capacity_factor), 1)
    bf16 = torch.bfloat16

    xf = x.reshape(G, t, d)
    w, idx, aux = _router(p, xf.reshape(T, d), m)
    # slot order: token-major within the group, k-minor; (t, k) -> s
    s = t * k
    e_flat = idx.reshape(G, s)
    w_flat = w.reshape(G, s)
    onehot_e = _one_hot(e_flat, E, bf16)                             # (G,s,E)
    pos = torch.cumsum(onehot_e.to(torch.float32), dim=1) - 1.0      # (G,s,E)
    pos = torch.sum(pos * onehot_e.to(torch.float32), dim=-1)       # (G,s)
    keep = pos < cap
    w_flat = w_flat * keep.to(w_flat.dtype)
    # one_hot of positions past the capacity is all zeros, as jax.nn.one_hot's
    onehot_c = _one_hot(pos.to(torch.int64), cap, bf16)              # (G,s,cap)

    x_rep = torch.repeat_interleave(xf, k, dim=1)                    # (G,s,d)
    dispatch = onehot_e[..., :, None] * onehot_c[..., None, :]      # (G,s,E,cap)
    dispatch = dispatch * keep[..., None, None].to(bf16)
    xe = einsum("gsec,gsd->gecd", dispatch, x_rep.to(bf16))    # (G,E,cap,d)
    wdt = torch.promote_types(bf16, p.w_gate.dtype)
    ye = _expert_ffn(p, xe.to(wdt))                                  # (G,E,cap,d)
    combine = dispatch * w_flat[..., None, None].to(bf16)
    ydt = torch.promote_types(bf16, ye.dtype)
    y = einsum("gsec,gecd->gsd", combine.to(ydt), ye.to(ydt))  # (G,s,d)
    y = y.reshape(G, t, k, d).sum(dim=2)
    return y.reshape(B, S, d).to(x.dtype), aux


def _batched(x: torch.Tensor) -> bool:
    """Whether `x` is mapped by torch.func.vmap (under any other transform)."""
    f = torch._C._functorch
    while f.is_functorch_wrapped_tensor(x):
        if f.is_batchedtensor(x):
            return True
        x = f.get_unwrapped(x)
    return False


def moe_forward_ragged(p: MoEParams, x: torch.Tensor,
                       m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based grouped products (no capacity drops). x: (B, S, d)."""
    if _batched(x) or any(_batched(t) for t in p):
        raise NotImplementedError("the ragged MoE dispatch has no batching rule under vmap "
                                  "(as the reference's ragged_dot); use moe_mode='onehot' or "
                                  "microbatch granularity")
    if spmd.mesh_of(x, *p) is not None:
        raise NotImplementedError("the ragged MoE dispatch does not run on a mesh: it reads the "
                                  "group sizes on the host, which a meta or fake-world step "
                                  "cannot; use moe_mode='onehot' there")
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    xf = x.reshape(T, d)
    w, idx, aux = _router(p, xf, m)

    e_flat = idx.reshape(T * k)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    rows = tok[order]
    xs = xf[rows]                                                   # (T*k, d)
    sizes = torch.bincount(e_flat, minlength=E).tolist()
    ys, start = [], 0
    for e, n in enumerate(sizes):
        xe = xs[start:start + n]
        gate = xe @ p.w_gate[e]
        up = xe @ p.w_up[e]
        ys.append((F.silu(gate) * up).to(xs.dtype) @ p.w_down[e])
        start += n
    ys = torch.cat(ys, dim=0)                                       # (T*k, d)
    wk = w.reshape(T * k)[order].to(torch.float32)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, rows, ys.to(torch.float32) * wk[:, None])
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_forward(p: MoEParams, x: torch.Tensor, m: MoEConfig, *, mode: str = "onehot",
                group_tokens: int = 512,
                capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    if mode == "ragged":
        return moe_forward_ragged(p, x, m)
    if mode != "onehot":
        raise ValueError(f"unknown MoE mode {mode!r} (onehot or ragged)")
    return moe_forward_onehot(p, x, m, group_tokens=group_tokens,
                              capacity_factor=capacity_factor)
