"""Error-feedback INT8 gradient compression (distributed-optim trick).

Counterpart of ``repro.optim.compression``: before the gradient
all-reduce, each worker quantizes its gradient to INT8 with a per-tensor
scale and keeps the quantization residual in an error-feedback buffer
added to the next step's gradient.  ``compress`` -> (int8 tree, scales,
new error state); ``decompress`` reconstructs f32 gradients.

The scale ``max(|corrected|, 1e-12) / 127`` divides by a tensor: PyTorch's
CUDA division by a Python number multiplies by its float32 reciprocal,
which moves rounding boundaries (as ``models.quant._div127`` notes).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


class EFState(NamedTuple):
    error: Any          # tree of f32 residuals (like grads)


def init(grads_like) -> EFState:
    return EFState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress(grads, state: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (q_tree int8, scale_tree f32 scalars, new_state)."""

    def one(g, e):
        corrected = g.to(torch.float32) + e
        amax = torch.clamp_min(corrected.abs().max(), 1e-12)
        scale = amax / torch.full_like(amax, 127.0)
        q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
        err = corrected - q.to(torch.float32) * scale
        return q, scale, err

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(state.error))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]),
            EFState(error=tree_unflatten(grads, [o[2] for o in out])))


def decompress(q_tree, scale_tree):
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scale_tree)


def compressed_bytes(q_tree) -> int:
    return sum(x.numel() for x in tree_leaves(q_tree))


def raw_bytes(grads) -> int:
    return sum(4 * x.numel() for x in tree_leaves(grads))
