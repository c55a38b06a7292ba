"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Dashed public ids map to underscore module names. Every entry also exposes a
``smoke`` reduced variant used by the per-arch CPU smoke tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke_config()
