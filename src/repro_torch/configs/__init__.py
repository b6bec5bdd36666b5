"""Config registry: one module per ported architecture.

Copied from the JAX package's registry; only the architectures the port
serves are registered (the others wait for their slice in ROADMAP.md).
"""
from . import base
from .base import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   ArchConfig, ShapeConfig, shape_applicable)

_ARCH_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
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
