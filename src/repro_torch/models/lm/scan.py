"""First-order linear recurrence along one axis, at log depth.

The port's counterpart of ``jax.lax.associative_scan`` as the SSM and
RG-LRU blocks use it (``repro/models/lm/ssm.py``, ``rglru.py``): for
elements (g_t, u_t) under the combine ``(ga, ua) . (gb, ub) = (ga gb,
ub + gb ua)``, the scanned u is the recurrence

    h_t = g_t h_{t-1} + u_t,   h_{-1} = 0.

It runs the recursive odd/even scheme that ``associative_scan`` runs:
combine adjacent pairs, scan the half-length sequence of pairs (which
gives h at the odd positions), then finish each even position from the
odd one before it.  The depth is about 2 log2(S) rounds of elementwise
torch ops, the work O(S), and it is differentiable.  No step loops over
the sequence: at S = 2,048 and 64 layers a loop of S steps would be
hundreds of thousands of launches.  Only h is returned, so the prefix
products of g, which no caller reads, are never formed.
"""

from __future__ import annotations

import torch


def _scan_leading(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h along axis 0 of g and u (same shape)."""
    n = u.shape[0]
    if n < 2:
        return u
    m = n // 2
    g_odd = g[1::2]
    # pairs (2i, 2i+1) combined: the element that ends at odd position 2i+1
    g_pair = g[0:2 * m:2] * g_odd
    u_pair = u[1::2] + g_odd * u[0:2 * m:2]
    h_odd = _scan_leading(g_pair, u_pair)             # h at 1, 3, ..., 2m-1
    g_even, u_even = g[2::2], u[2::2]                 # positions 2, 4, ...
    h_even = torch.cat([u[:1], u_even + g_even * h_odd[:g_even.shape[0]]])
    pairs = torch.stack([h_even[:m], h_odd], dim=1).reshape(2 * m, *u.shape[1:])
    return pairs if n == 2 * m else torch.cat([pairs, h_even[m:]])


def linear_scan(g: torch.Tensor, u: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """h_t = g_t h_{t-1} + u_t along ``dim`` (h before the first step is
    0); g and u share one shape, h has it too."""
    if g.shape != u.shape:
        raise ValueError(f"g {tuple(g.shape)} and u {tuple(u.shape)} differ")
    h = _scan_leading(g.movedim(dim, 0), u.movedim(dim, 0))
    return h.movedim(0, dim)
