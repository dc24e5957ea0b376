"""Architecture registry of the port: the dense decoders, the Mamba-1 SSM,
the RG-LRU hybrid and the MoE decoders whose paths are ported so far. The
other architectures of the JAX package wait for the slices that port
their families (enc-dec, VLM) or their configs.

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
    "glm4-9b": "glm4_9b",
    "granite-8b": "granite_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
}

# architectures of the JAX package that a later slice of the port brings in
_LATER = ("internlm2-20b", "command-r-35b", "whisper-small", "internvl2-1b")

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id in _LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet (a later slice "
                       f"of the port); ported: {sorted(_ARCH_MODULES)}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
