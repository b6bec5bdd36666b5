"""Config registry: one module per ported architecture.

Copied from the JAX package's registry: the same ten architectures.
"""
from . import base
from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ArchConfig, ShapeConfig, shape_applicable)

_ARCH_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-34b": "granite_34b",
    "qwen1.5-32b": "qwen1_5_32b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "musicgen-medium": "musicgen_medium",
    "mixtral-8x22b": "mixtral_8x22b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-350m": "xlstm_350m",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    import importlib

    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
