"""Stand-ins for every model input: tensors on the meta device (shape and
dtype, no storage, nothing drawn). Counterpart of ``repro/launch/specs.py``,
whose ShapeDtypeStructs these are.

Modality carve-out: for [audio]/[vlm] archs the stubbed frontend's outputs
(frame/patch embeddings) appear here as inputs of the right shape.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import LM

META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    """A stand-in of `shape` and `dtype` on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def effective_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Sliding window in effect for this (arch, shape).

    long_500k on archs with full attention uses the documented SWA override;
    otherwise the arch's native window (mixtral) or None.
    """
    if shape.name == "long_500k" and cfg.long_context_override:
        return cfg.long_context_override
    return cfg.sliding_window


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, with_labels: bool = True,
                      microbatches: int = 0) -> Dict[str, torch.Tensor]:
    """microbatches > 0: the microbatch-major layout (G, B/G, ...) that a
    pre-grouped privatizer takes."""
    B, S = shape.global_batch, shape.seq_len
    lead = (microbatches, B // microbatches) if microbatches else (B,)
    specs: Dict[str, torch.Tensor] = {}
    s_txt = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    specs["tokens"] = meta(lead + (s_txt,), torch.int32)
    if with_labels:
        specs["labels"] = meta(lead + (s_txt,), torch.int32)
    if cfg.family == "vlm":
        specs["patches"] = meta(lead + (cfg.n_patches, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        specs["frames"] = meta(lead + (cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return specs


def params_specs(model: LM, dtype=torch.bfloat16) -> Any:
    """The model's params on the meta device: `LM.init`'s meta path draws
    and allocates nothing (no seed is consumed)."""
    return model.init(device=META, dtype=dtype)


def cache_specs_struct(model: LM, shape: ShapeConfig, dtype=torch.bfloat16) -> Any:
    w = effective_window(model.cfg, shape)
    return model.init_cache(shape.global_batch, shape.seq_len, window=w, dtype=dtype,
                            device=META)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return meta((shape.global_batch, 1), torch.int32), meta((), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, model: LM) -> Dict:
    """Everything a step consumes, by shape kind."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape),
                "owner_idx": meta((), torch.int32),
                "noise_key": meta((2,), torch.uint32)}
    if shape.kind == "prefill":
        return {"batch": train_batch_specs(cfg, shape, with_labels=False)}
    if shape.kind == "decode":
        toks, pos = decode_input_specs(cfg, shape)
        return {"cache": cache_specs_struct(model, shape), "tokens": toks, "pos": pos}
    raise ValueError(shape.kind)
