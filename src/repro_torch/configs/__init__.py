"""Architecture registry of the port (the archs ported so far)."""
from __future__ import annotations

import importlib
from typing import List

from .base import ArchConfig

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen3-4b": "qwen3_4b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {list_archs()}")
    return importlib.import_module(f".{_ARCH_MODULES[name]}", __package__).CONFIG


__all__ = ["ArchConfig", "get_config", "list_archs"]
