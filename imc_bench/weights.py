"""Weights and frames made from the seed, on the device, in a few calls."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Leaf(NamedTuple):
    """One parameter: its shape and the standard deviation of its normal
    draw."""
    shape: Tuple[int, ...]
    std: float


def _leaves(tree, out):
    if isinstance(tree, Leaf):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        for v in tree:
            _leaves(v, out)
    return out


def make(tree, generator: torch.Generator):
    """The tree of ``Leaf`` specs as tensors: every leaf a view into one
    normal draw on ``generator``'s device, scaled by its ``std`` in one
    multiply."""
    leaves = _leaves(tree, [])
    sizes = [torch.Size(leaf.shape).numel() for leaf in leaves]
    device = generator.device
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    flat *= torch.repeat_interleave(
        torch.tensor([leaf.std for leaf in leaves], device=device),
        torch.tensor(sizes, device=device))
    views = iter(torch.split(flat, sizes))

    def build(t):
        if isinstance(t, Leaf):
            return next(views).view(t.shape)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return [build(v) for v in t]
    return build(tree)


def frames(generator: torch.Generator, n: int, batch: int,
           hw: Tuple[int, int]) -> torch.Tensor:
    """``n`` batches of ``batch`` NHWC frames of ``hw`` with 3 channels,
    uniform in [0, 1) as normalised pixels: (n, batch, H, W, 3)."""
    return torch.rand((n, batch, *hw, 3), generator=generator,
                      device=generator.device)
