"""Architecture registry of the port: ``--arch <id>`` resolution over the
reference's ten architectures (``repro/configs/registry.py``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "qwen1.5-110b": "repro_torch.configs.qwen1p5_110b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "granite-20b": "repro_torch.configs.granite_20b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in list_archs()}
