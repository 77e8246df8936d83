"""Analytic FLOPs of a training round (forward and backward, no recompute,
no privatizer), from a configuration's shapes.

A product of an (m, k) and a (k, n) operand counts 2 m k n. The forward
counts every weight product (projections, MLP, LM head), the causal
attention's two products over the S (S + 1) / 2 query-key pairs a sequence
needs, the depthwise conv's FMAs and the SSD scan's operations as the
ssm_scan kernel's formula (`kernels.ssd_fwd_ops`); the backward counts
twice the forward (a gradient for each operand of every product)."""
from __future__ import annotations

from bench.reference.model import ModelSpec
from bench.roofline import kernels


def linear_flops(cfg: ModelSpec, tokens: int) -> int:
    """Forward FLOPs of the weight products over `tokens` tokens."""
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * H * hd + 2 * d * Kv * hd + H * hd * d
    head = d * cfg.vocab
    if cfg.family == "dense":
        per_layer = attn + 3 * d * cfg.d_ff
        return 2 * tokens * (cfg.n_layers * per_layer + head)
    di, N, Hs = cfg.d_inner, cfg.d_state, cfg.ssm_heads
    mamba = d * (2 * di + 2 * N + Hs) + di * d
    n_attn = cfg.n_layers // cfg.attn_every
    return 2 * tokens * (cfg.n_layers * mamba + n_attn * attn + head)


def attention_flops(cfg: ModelSpec, batch: int, seq: int) -> int:
    """Forward FLOPs of the causal attention products (q k^T and p v)."""
    n_attn = cfg.n_layers if cfg.family == "dense" else cfg.n_layers // cfg.attn_every
    return n_attn * batch * cfg.n_heads * 2 * (2 * cfg.head_dim * seq * (seq + 1) // 2)


def mixer_flops(cfg: ModelSpec, batch: int, seq: int) -> int:
    """Forward FLOPs of the Mamba2 layers' conv and SSD scan (0 for dense)."""
    if cfg.family != "hybrid":
        return 0
    conv = 2 * batch * seq * cfg.d_conv * (cfg.d_inner + 2 * cfg.d_state)
    scan = kernels.ssd_fwd_ops(batch, seq, cfg.ssm_heads, cfg.d_state, cfg.ssm_head_dim,
                               cfg.chunk)
    return cfg.n_layers * (conv + scan)


def forward_flops(cfg: ModelSpec, batch: int, seq: int) -> int:
    return (linear_flops(cfg, batch * seq) + attention_flops(cfg, batch, seq)
            + mixer_flops(cfg, batch, seq))


def train_flops(cfg: ModelSpec, batch: int, seq: int) -> int:
    """Forward and backward FLOPs of one round's batch."""
    return 3 * forward_flops(cfg, batch, seq)
