"""Architecture registry of the port: the ten architectures of the JAX
package, in its order, one module each.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family config of the tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    shape_applicable,
)

_ARCH_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "internlm2-20b": "internlm2_20b",
    "glm4-9b": "glm4_9b",
    "command-r-35b": "command_r_35b",
    "granite-8b": "granite_8b",
    "whisper-small": "whisper_small",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-1b": "internvl2_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
