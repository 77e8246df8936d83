"""Command-R-35B — dense GQA, no biases, 256k vocab, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01]. A copy of
``repro/configs/command_r_35b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    tie_embeddings=True,  # command-r ties input/output embeddings
    rope_theta=8e6,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
