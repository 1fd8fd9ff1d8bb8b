"""Carry a parameter tree of the JAX package over to the port.

The reference's trees are nested dicts and lists whose leaves are arrays
(numpy, or anything ``numpy.asarray`` takes).  The port keeps the same
structure and layouts (HWIO conv weights, (in, out) dense weights), so
the conversion is leaf by leaf, with no transposes.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device="cuda"):
    """Nested dicts/lists/tuples of arrays -> the same structure of
    tensors on ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)
