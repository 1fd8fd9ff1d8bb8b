"""Arch config registry of the port (counterpart of ``repro.configs``).

It holds the dense, attention-only architectures that the port's LM
modules run.  The other families of the reference's registry (MoE, SSM,
recurrent, enc-dec, VLM) wait for their slice: asking for one raises
``KeyError`` naming the ``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

from importlib import import_module

from .base import GLOBAL_WINDOW, SHAPES, LMConfig, Segment, ShapeSpec

_ARCH_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "gemma3-1b": "gemma3_1b",
    "gemma2-27b": "gemma2_27b",
    "starcoder2-3b": "starcoder2_3b",
}

#: archs of the reference that the port does not run yet
_NOT_PORTED = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
               "whisper-small", "paligemma-3b", "recurrentgemma-9b")


def get_config(arch: str) -> LMConfig:
    if arch in _NOT_PORTED:
        raise KeyError(f"arch '{arch}' is not ported yet: see ROADMAP.md §1, "
                       "'Other LM families'")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch '{arch}'; have {sorted(_ARCH_MODULES)}")
    mod = import_module(f"{__name__}.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_archs() -> list:
    return sorted(_ARCH_MODULES)


__all__ = ["LMConfig", "Segment", "ShapeSpec", "SHAPES", "GLOBAL_WINDOW",
           "get_config", "all_archs"]
