"""Mixtral-8x22B — sparse MoE, 8 experts top-2, SWA [arXiv:2401.04088]. A
copy of ``repro/configs/mixtral_8x22b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    sliding_window=4096,          # native SWA -> long_500k is sub-quadratic
    long_context_override=None,   # not needed: native window
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
