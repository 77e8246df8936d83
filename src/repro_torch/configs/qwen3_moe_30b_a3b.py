"""Qwen3-30B-A3B — fine-grained MoE, 128 experts top-8, d_expert=768
[hf:Qwen/Qwen3-30B-A3B]. A copy of ``repro/configs/qwen3_moe_30b_a3b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                      # per-expert hidden dim per assignment
    vocab=151936,
    head_dim=128,                  # qwen3 uses hd=128 (> d_model/n_heads)
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
