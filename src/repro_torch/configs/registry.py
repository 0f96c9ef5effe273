"""Architecture registry of the port.

Port of ``repro.configs.registry`` for the architectures the port runs:
9 of the reference's 10. ``get_config(name)`` returns the full assigned
config, ``smoke_config`` the reduced same-family variant the CPU tests
use. The other assigned architecture (deepseek-v3-671b) raises: ROADMAP.md
lists it as still to be ported.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

#: architectures the port runs: 9 of the reference's ARCH_IDS' 10
ARCH_IDS = ("qwen3_0_6b", "jamba_v0_1_52b", "xlstm_350m", "starcoder2_3b",
            "whisper_base", "qwen3_moe_30b_a3b", "chameleon_34b",
            "gemma_7b", "minicpm3_4b")

# CLI-facing aliases (the assignment's hyphenated ids)
ALIASES = {"qwen3-0.6b": "qwen3_0_6b",
           "jamba-v0.1-52b": "jamba_v0_1_52b",
           "xlstm-350m": "xlstm_350m",
           "starcoder2-3b": "starcoder2_3b",
           "whisper-base": "whisper_base",
           "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "chameleon-34b": "chameleon_34b",
           "gemma-7b": "gemma_7b",
           "minicpm3-4b": "minicpm3_4b"}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (the port runs "
            f"{', '.join(ARCH_IDS)}); ROADMAP.md lists the rest")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
