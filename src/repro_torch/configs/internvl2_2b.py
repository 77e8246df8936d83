"""InternVL2-2B — InternViT frontend (stubbed) + InternLM2 LLM backbone
[arXiv:2404.16821]. The vision encoder is a stub: `patches` carries 256
precomputed patch embeddings per image. A copy of
``repro/configs/internvl2_2b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    n_patches=256,
    source="arXiv:2404.16821",
)
