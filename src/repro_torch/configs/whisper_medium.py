"""Whisper-medium — encoder-decoder backbone [arXiv:2212.04356]. The
mel-spectrogram + conv frontend is a stub: `frames` carries 1500
precomputed frame embeddings (B, 1500, 1024). n_layers=24 is the decoder
depth; the encoder is 24 layers as well. A copy of
``repro/configs/whisper_medium.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    enc_layers=24,
    enc_seq=1500,
    source="arXiv:2212.04356",
)
