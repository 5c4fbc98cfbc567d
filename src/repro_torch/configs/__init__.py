"""Architecture registry: ``--arch <id>`` → ModelConfig (a copy of
``repro.configs``)."""
from __future__ import annotations


from .base import ModelConfig, ShapeConfig, SHAPES, get_shape

from . import (
    minitron_8b,
    smollm_360m,
    yi_6b,
    granite_3_2b,
    deepseek_v2_lite_16b,
    deepseek_v3_671b,
    musicgen_large,
    pixtral_12b,
    jamba_1_5_large_398b,
    mamba2_370m,
)

_MODULES = {
    "minitron-8b": minitron_8b,
    "smollm-360m": smollm_360m,
    "yi-6b": yi_6b,
    "granite-3-2b": granite_3_2b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "musicgen-large": musicgen_large,
    "pixtral-12b": pixtral_12b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "mamba2-370m": mamba2_370m,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _MODULES[arch].reduced()


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "get_reduced_config",
    "get_shape",
]
