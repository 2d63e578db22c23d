"""Architecture registry, the port's copy of ``src/repro/configs/registry.py``
without the JAX dry run's ``input_specs`` and ``abstract_params``."""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "stablelm-12b",
    "qwen3-14b",
    "starcoder2-7b",
    "gemma-7b",
    "rwkv6-1.6b",
    "internvl2-2b",
    "qwen3-moe-30b-a3b",
    "dbrx-132b",
    "zamba2-7b",
    "whisper-medium",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
