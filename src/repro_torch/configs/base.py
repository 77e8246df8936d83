"""Model architecture and input-shape configs of the port: an own copy of
``repro/configs/base.py`` (`MoEConfig`, `SSMConfig`, `XLSTMConfig`,
`ModelConfig`, `ShapeConfig`, `INPUT_SHAPES`) and the repo's deep example
model.

``ModelConfig.reduced()`` gives the CPU-test variant exactly as the
reference does (2 layers, d_model <= 256, <= 4 heads, vocab <= 512; for a
hybrid d_state <= 16, SSD head dim 32, chunk 32 and a shared attention
block every 2 layers; <= 4 experts, top-k <= 2, d_expert <= 128; the
sLSTM at layer 1; 2 encoder layers over 16 frames; 4 patches), so a
reduced config describes the same parameter shapes in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# the families the port runs: every family of the reference
PORTED_FAMILIES = ("dense", "hybrid", "moe", "ssm", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int            # per-expert hidden dim
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block dims."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2          # d_inner = expand * d_model
    head_dim: int = 64       # SSD head dim; n_ssm_heads = d_inner // head_dim
    chunk: int = 256         # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_indices: Tuple[int, ...] = ()   # which layers are sLSTM (the rest mLSTM)
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                             # 'dense', 'hybrid', 'moe', 'ssm', 'vlm' or 'audio'
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): a *shared* attention block applied after every
    # `attn_every` Mamba2 layers
    attn_every: Optional[int] = None
    # enc-dec (whisper): encoder depth and fixed encoder sequence length
    # (frames after the stubbed conv frontend)
    enc_layers: int = 0
    enc_seq: int = 0
    # vlm (internvl2): patch embeddings prepended by the stubbed vision
    # frontend
    n_patches: int = 0
    source: str = ""                        # citation

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")

    @property
    def is_decoder(self) -> bool:
        return True  # every assigned arch has a decoder

    def param_count(self) -> int:
        """Analytic parameter count: the number of elements `LM.init` makes
        (the size P of the packed flat buffer), the final norm included. The
        reference's `param_count` is a rougher formula: for the hybrid it
        leaves out w_dt, the conv, A_log, D, dt_bias and the norms; for the
        xLSTM it estimates a layer as 2 d dm + dm d / 2 (112,656,384 for
        xlstm-125m against the 199,584,812 leaves its init makes); for the
        dense, moe and vlm families it leaves out the final norm, and for
        the vlm `patch_proj` too; it counts the audio decoder as SwiGLU
        dense blocks, without their cross-attention, third norm, `enc_pos`
        and `enc_ln_f`."""
        d, hd, H, Kv = self.d_model, self.head_dim, self.n_heads, self.n_kv_heads
        emb = self.vocab * d
        out = 0 if self.tie_embeddings else self.vocab * d
        attn = d * H * hd + 2 * d * Kv * hd + H * hd * d
        if self.family == "audio":
            # whisper's attention blocks carry no bias, whatever qkv_bias says
            gelu = 2 * d * self.d_ff
            dec = 2 * attn + gelu + 3 * d
            enc = attn + gelu + 2 * d
            return (emb + out + self.n_layers * dec + self.enc_layers * enc
                    + self.enc_seq * d + 2 * d)
        if self.qkv_bias:
            attn += (H + 2 * Kv) * hd
        if self.family in ("dense", "moe", "vlm"):
            if self.moe is not None:
                m = self.moe
                ffn = m.n_experts * 3 * d * m.d_expert + d * m.n_experts
            else:
                ffn = 3 * d * self.d_ff
            patch = d * d if self.family == "vlm" else 0
            return emb + out + self.n_layers * (attn + ffn + 2 * d) + d + patch
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            mamba = (3 * d * d_in + 2 * d * s.d_state + d * n_h
                     + s.d_conv * (d_in + 2 * s.d_state) + 3 * n_h + d_in)
            return emb + out + self.n_layers * (mamba + d) + attn + 2 * d
        if self.family == "ssm":
            x = self.xlstm or XLSTMConfig()
            dm = int(d * x.mlstm_proj_factor)
            n_h = self.n_heads
            mlstm = 2 * d * dm + x.conv_kernel * dm + 3 * dm * dm + 2 * dm * n_h + n_h + dm + dm * d
            hd_s = d // n_h
            fs = int(d * x.slstm_proj_factor)
            slstm = d * d * 4 + n_h * hd_s * hd_s * 4 + d * 4 + d + d * 2 * fs + fs * d
            n_s = sum(1 for i in range(self.n_layers) if i in x.slstm_indices)
            return emb + out + n_s * slstm + (self.n_layers - n_s) * mlstm + d
        raise ValueError(f"unknown family {self.family!r}")

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts), from
        `param_count` as the reference derives it."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        all_exp = self.n_layers * m.n_experts * 3 * self.d_model * m.d_expert
        act_exp = self.n_layers * m.top_k * 3 * self.d_model * m.d_expert
        return self.param_count() - all_exp + act_exp

    def reduced(self) -> "ModelConfig":
        """2-layer, d_model <= 256, <= 4-expert variant of the same family
        (the reference's rule)."""
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
            moe=(dataclasses.replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                                     top_k=min(self.moe.top_k, 2),
                                     d_expert=min(self.moe.d_expert, 128))
                 if self.moe else None),
            ssm=(dataclasses.replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                                     head_dim=32, chunk=32) if self.ssm else None),
            xlstm=(dataclasses.replace(self.xlstm, slstm_indices=(1,)) if self.xlstm else None),
            attn_every=2 if self.attn_every else None,
            enc_layers=2 if self.enc_layers else 0, enc_seq=16 if self.enc_layers else 0,
            n_patches=4 if self.n_patches else 0,
            source=self.source)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# The repo's deep example model (examples/async_dp_llm.py:38): a 12-layer
# GQA transformer, P = 152,783,616 f32 parameters.
DENSE_124M = ModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab=50304,
    source="gpt2-small-like demo config")
