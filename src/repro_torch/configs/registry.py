"""Architecture registry of the port: ``--arch <id>`` resolution over the
architectures the port runs. The reference's other architectures raise a
KeyError naming the slice they wait for."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "yi-6b": "repro_torch.configs.yi_6b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}

# the reference's architectures that the port does not run yet, and why
_WAITING = {
    "internvl2-2b": "the vlm family",
    "whisper-medium": "the audio family",
    "qwen1.5-110b": "sharding over cards (ROADMAP queue 1, item 7)",
    "granite-20b": "sharding over cards (ROADMAP queue 1, item 7)",
    "command-r-35b": "sharding over cards (ROADMAP queue 1, item 7)",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _WAITING:
        raise KeyError(f"arch {arch!r} waits for a later slice of the port: "
                       f"{_WAITING[arch]}; the port runs {list_archs()}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in list_archs()}
