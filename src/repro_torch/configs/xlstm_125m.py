"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517].

12 blocks at ratio ~7:1 mLSTM:sLSTM -> sLSTM at layer index 6.
d_ff=0: xLSTM blocks carry their own gated up/down projections. A copy of
``repro/configs/xlstm_125m.py``.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    xlstm=XLSTMConfig(slstm_indices=(6,)),
    long_context_override=None,  # recurrent: natively O(1)-state decode
    source="arXiv:2405.04517",
)
