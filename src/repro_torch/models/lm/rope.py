"""Rotary position embeddings (RoPE), decode-aware.

Counterpart of ``repro.models.lm.rope``.  As there, ``apply_rope``
rotates the two halves of the head dimension against each other (x[i]
with x[i + hd/2]), although the reference's docstring speaks of
interleaved pairs; the port keeps what the code does.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0) -> tuple:
    """(…,) int positions -> (…, head_dim/2) float32 cos/sin tables."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (seq, head_dim/2).  The
    rotation runs in float32 (a bf16 ``x`` is promoted by the float32
    tables, as in the reference) and the result is cast back to x's
    dtype."""
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
