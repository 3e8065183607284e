"""Assigned architecture configs (``--arch <id>``).

Each module exports ``CONFIG`` (the exact published config) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ArchConfig

ARCH_IDS = [
    "pixtral_12b",
    "deepseek_v3_671b",
    "qwen3_moe_30b_a3b",
    "zamba2_7b",
    "falcon_mamba_7b",
    "gemma_7b",
    "granite_8b",
    "smollm_360m",
    "tinyllama_1_1b",
    "whisper_base",
]

# canonical dashed ids from the assignment
DASHED = {
    "pixtral-12b": "pixtral_12b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-7b": "zamba2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma-7b": "gemma_7b",
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "whisper-base": "whisper_base",
}


def _module(arch: str) -> str:
    return DASHED.get(arch, arch).replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{_module(arch)}").CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return importlib.import_module(f"repro_torch.configs.{_module(arch)}").smoke_config()


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
