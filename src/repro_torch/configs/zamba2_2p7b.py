"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560; a single *shared* full-attention block
(32 heads, kv=32) is applied every 6 layers (weights reused — Zamba's
signature parameter-sharing trick). ssm_state=64. A copy of
``repro/configs/zamba2_2p7b.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    attn_every=6,
    long_context_override=8192,  # shared-attn blocks window at 500k
    source="arXiv:2411.15242",
)
