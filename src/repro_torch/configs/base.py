"""Model architecture config of the port: an own copy of the dense subset of
``repro/configs/base.py::ModelConfig`` and the repo's deep example model.

``ModelConfig.reduced()`` gives the CPU-test variant exactly as the
reference does (2 layers, d_model <= 256, <= 4 heads, vocab <= 512), so a
reduced config describes the same parameter shapes in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                             # only 'dense' runs in the port so far
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
    source: str = ""                        # citation

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")

    def param_count(self) -> int:
        """Analytic parameter count of the dense family (equals the size P
        of the packed flat buffer)."""
        d, hd, H, Kv = self.d_model, self.head_dim, self.n_heads, self.n_kv_heads
        emb = self.vocab * d
        out = 0 if self.tie_embeddings else self.vocab * d
        attn = d * H * hd + 2 * d * Kv * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * Kv) * hd
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return emb + out + self.n_layers * per_layer + d

    def reduced(self) -> "ModelConfig":
        """2-layer, d_model <= 256 variant (the reference's rule)."""
        d = min(self.d_model, 256)
        H = min(self.n_heads, 4)
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        return ModelConfig(
            name=self.name + "-smoke", family=self.family, n_layers=2,
            d_model=d, n_heads=H, n_kv_heads=max(1, H // ratio),
            d_ff=min(self.d_ff, 512), vocab=min(self.vocab, 512), head_dim=d // H,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta, source=self.source)


# The repo's deep example model (examples/async_dp_llm.py:38): a 12-layer
# GQA transformer, P = 152,783,616 f32 parameters.
DENSE_124M = ModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab=50304,
    source="gpt2-small-like demo config")
