"""Architecture registry of the port: every arch of the reference."""
from __future__ import annotations

import importlib
from typing import List

from .base import ArchConfig

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen3-4b": "qwen3_4b",
    "gemma-7b": "gemma_7b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-medium": "whisper_medium",
    "paligemma-3b": "paligemma_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(f".{_ARCH_MODULES[name]}", __package__).CONFIG


__all__ = ["ArchConfig", "get_config", "list_archs"]
