"""Granite-20B (code) — llama-architecture with MQA (kv=1)
[arXiv:2405.04324]. A copy of ``repro/configs/granite_20b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    source="arXiv:2405.04324",
)
