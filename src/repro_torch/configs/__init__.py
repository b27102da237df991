"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()`` (a copy of
``repro.configs``, which the port may not import).

One module per assigned architecture; each exports ``CONFIG``.
"""
from __future__ import annotations

import importlib

from .base import LONG_CONTEXT_FAMILIES, SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = [
    "gemma3_27b",
    "yi_9b",
    "mistral_nemo_12b",
    "qwen3_4b",
    "rwkv6_3b",
    "recurrentgemma_2b",
    "llama4_scout_17b_a16e",
    "dbrx_132b",
    "internvl2_76b",
    "whisper_base",
]

_CACHE: dict[str, ModelConfig] = {}


def list_archs() -> list[str]:
    return [m.replace("_", "-") for m in _ARCH_MODULES]


def get_config(arch_id: str) -> ModelConfig:
    key = arch_id.replace("-", "_")
    if key not in _CACHE:
        mod = importlib.import_module(f".{key}", __name__)
        _CACHE[key] = mod.CONFIG
    return _CACHE[key]


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch x shape) is a lowered cell or a documented skip."""
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True
