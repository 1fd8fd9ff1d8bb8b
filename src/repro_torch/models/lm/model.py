"""Model API of the port: the serving steps.

Counterpart of the serving part of ``repro.models.lm.model``
(``make_prefill_step``, ``make_decode_step``).  PyTorch runs eagerly, so
the steps are plain closures where the reference returns functions to
``jax.jit``.  Loss, train step and dry-run specs come with the training
slice.
"""

from __future__ import annotations

from ...configs.base import LMConfig
from . import transformer


def make_prefill_step(cfg: LMConfig, s_max: int):
    def prefill_step(params, batch):
        return transformer.prefill(cfg, params, batch["tokens"], s_max)
    return prefill_step


def make_decode_step(cfg: LMConfig):
    def decode_step(params, token, cache):
        return transformer.decode(cfg, params, token, cache)
    return decode_step
