"""Architecture registry of the port.

Port of ``repro.configs.registry``: all 10 of the reference's assigned
architectures. ``get_config(name)`` returns the full assigned config,
``smoke_config`` the reduced same-family variant the CPU tests use. Any
other name raises.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

#: architectures the port runs: the reference's ARCH_IDS, all 10
ARCH_IDS = ("qwen3_0_6b", "jamba_v0_1_52b", "xlstm_350m", "starcoder2_3b",
            "whisper_base", "qwen3_moe_30b_a3b", "chameleon_34b",
            "gemma_7b", "minicpm3_4b", "deepseek_v3_671b")

# CLI-facing aliases (the assignment's hyphenated ids)
ALIASES = {"qwen3-0.6b": "qwen3_0_6b",
           "jamba-v0.1-52b": "jamba_v0_1_52b",
           "xlstm-350m": "xlstm_350m",
           "starcoder2-3b": "starcoder2_3b",
           "whisper-base": "whisper_base",
           "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "chameleon-34b": "chameleon_34b",
           "gemma-7b": "gemma_7b",
           "minicpm3-4b": "minicpm3_4b",
           "deepseek-v3-671b": "deepseek_v3_671b"}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}: the port runs "
                         f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
