"""Arch config registry of the port (counterpart of ``repro.configs``):
one module per assigned architecture, the same ten as the reference's."""

from __future__ import annotations

from importlib import import_module

from .base import GLOBAL_WINDOW, SHAPES, LMConfig, Segment, ShapeSpec, \
    shape_supported

_ARCH_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "gemma3-1b": "gemma3_1b",
    "gemma2-27b": "gemma2_27b",
    "starcoder2-3b": "starcoder2_3b",
    "whisper-small": "whisper_small",
    "paligemma-3b": "paligemma_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(arch: str) -> LMConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch '{arch}'; have {sorted(_ARCH_MODULES)}")
    mod = import_module(f"{__name__}.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_archs() -> list:
    return sorted(_ARCH_MODULES)


__all__ = ["LMConfig", "Segment", "ShapeSpec", "SHAPES", "GLOBAL_WINDOW",
           "shape_supported", "get_config", "all_archs"]
