"""Carry a parameter tree of the JAX package over to the port.

The reference's trees are nested dicts, lists and NamedTuples whose leaves
are arrays (numpy, or anything ``numpy.asarray`` takes).  The port keeps
the same structure and layouts (HWIO conv weights, (in, out) dense
weights, LM layers stacked on a leading (L, ...) axis), so the conversion
is leaf by leaf, with no transposes.  Each NamedTuple of the reference
(``AttnParams``, ``GatedMLP``, ``PlainMLP``, ``KVCache``, ``MoEParams``,
``SSMParams``, ``SSMState``, ``RGLRUParams``, ``RGLRUState``, and the
optimizer states ``AdamWState`` and ``EFState``) becomes the port's
NamedTuple of the same name and fields, found by name: nothing of
the reference is imported.  bfloat16 leaves are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.lm.attention import AttnParams, KVCache
from .models.lm.mlp import GatedMLP, PlainMLP
from .models.lm.moe import MoEParams
from .models.lm.rglru import RGLRUParams, RGLRUState
from .models.lm.ssm import SSMParams, SSMState
from .optim.adamw import AdamWState
from .optim.compression import EFState

_NAMED = {cls.__name__: cls for cls in (
    AttnParams, KVCache, GatedMLP, PlainMLP, MoEParams, SSMParams, SSMState,
    RGLRUParams, RGLRUState, AdamWState, EFState)}


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":      # ml_dtypes.bfloat16: same 16 bits
        bits = torch.from_numpy(np.array(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def from_jax_params(tree, device="cuda"):
    """Nested dicts/lists/tuples/NamedTuples of arrays -> the same structure
    of tensors on ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _NAMED.get(type(tree).__name__)
        if cls is None or cls._fields != tree._fields:
            raise TypeError(f"no counterpart in the port for NamedTuple "
                            f"{type(tree).__name__}{tree._fields}")
        return cls(*(from_jax_params(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    return _tensor(tree, device)
