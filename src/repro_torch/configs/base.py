"""Model architecture config of the port: an own copy of the dense and
hybrid subset of ``repro/configs/base.py`` (`SSMConfig`, `ModelConfig`)
and the repo's deep example model.

``ModelConfig.reduced()`` gives the CPU-test variant exactly as the
reference does (2 layers, d_model <= 256, <= 4 heads, vocab <= 512; for a
hybrid d_state <= 16, SSD head dim 32, chunk 32 and a shared attention
block every 2 layers), so a reduced config describes the same parameter
shapes in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# the families the port runs; the others wait for later slices
PORTED_FAMILIES = ("dense", "hybrid")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block dims."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2          # d_inner = expand * d_model
    head_dim: int = 64       # SSD head dim; n_ssm_heads = d_inner // head_dim
    chunk: int = 256         # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                             # 'dense' or 'hybrid' in the port so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    sliding_window: Optional[int] = None    # native sliding-window attention
    # sub-quadratic override used only for the long_500k shape on archs with
    # full attention (not applied by the port yet)
    long_context_override: Optional[int] = 8192
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a *shared* attention block applied after every
    # `attn_every` Mamba2 layers
    attn_every: Optional[int] = None
    source: str = ""                        # citation

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")

    def param_count(self) -> int:
        """Analytic parameter count: the number of elements `LM.init` makes
        (the size P of the packed flat buffer). For the hybrid it counts
        every Mamba2 leaf, where the reference's `param_count` leaves out
        w_dt, the conv, A_log, D, dt_bias and the norms."""
        d, hd, H, Kv = self.d_model, self.head_dim, self.n_heads, self.n_kv_heads
        emb = self.vocab * d
        out = 0 if self.tie_embeddings else self.vocab * d
        attn = d * H * hd + 2 * d * Kv * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * Kv) * hd
        if self.family == "dense":
            per_layer = attn + 3 * d * self.d_ff + 2 * d
            return emb + out + self.n_layers * per_layer + d
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            mamba = (3 * d * d_in + 2 * d * s.d_state + d * n_h
                     + s.d_conv * (d_in + 2 * s.d_state) + 3 * n_h + d_in)
            return emb + out + self.n_layers * (mamba + d) + attn + 2 * d
        raise NotImplementedError(f"family {self.family!r} waits for a later slice of the port")

    def reduced(self) -> "ModelConfig":
        """2-layer, d_model <= 256 variant (the reference's rule)."""
        d = min(self.d_model, 256)
        H = min(self.n_heads, 4)
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        return ModelConfig(
            name=self.name + "-smoke", family=self.family, n_layers=2,
            d_model=d, n_heads=H, n_kv_heads=max(1, H // ratio),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0, vocab=min(self.vocab, 512),
            head_dim=d // H, qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            long_context_override=64 if self.long_context_override else None,
            ssm=(dataclasses.replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                                     head_dim=32, chunk=32) if self.ssm else None),
            attn_every=2 if self.attn_every else None,
            source=self.source)


# The repo's deep example model (examples/async_dp_llm.py:38): a 12-layer
# GQA transformer, P = 152,783,616 f32 parameters.
DENSE_124M = ModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab=50304,
    source="gpt2-small-like demo config")
