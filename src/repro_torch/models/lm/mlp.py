"""MLP blocks: gated (SiLU/GeLU-GLU, llama/gemma-style) and plain
two-matrix (GPT-style), plus RMSNorm / LayerNorm.

Counterpart of ``repro.models.lm.mlp``.  GeLU is the tanh approximation,
which is ``jax.nn.gelu``'s default (PyTorch's default is the exact erf
form).  RMSNorm multiplies by ``scale`` (not ``1 + scale``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class GatedMLP(NamedTuple):
    w_gate: torch.Tensor   # (D, F)
    w_up: torch.Tensor     # (D, F)
    w_down: torch.Tensor   # (F, D)


class PlainMLP(NamedTuple):
    w_in: torch.Tensor     # (D, F)
    b_in: torch.Tensor
    w_out: torch.Tensor    # (F, D)
    b_out: torch.Tensor


def normal(generator: torch.Generator, shape, std: float, dtype=torch.bfloat16,
           device="cuda") -> torch.Tensor:
    """N(0, std^2) drawn in float32 on the generator's device, cast to
    ``dtype`` and moved to ``device`` (one CPU seed gives the same values
    on every device).  On the ``meta`` device: the shape only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(dtype).to(device)


def init_gated(generator: torch.Generator, d: int, f: int, dtype=torch.bfloat16,
               device="cuda") -> GatedMLP:
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return GatedMLP(normal(generator, (d, f), s, dtype, device),
                    normal(generator, (d, f), s, dtype, device),
                    normal(generator, (f, d), so, dtype, device))


def init_plain(generator: torch.Generator, d: int, f: int, dtype=torch.bfloat16,
               device="cuda") -> PlainMLP:
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return PlainMLP(normal(generator, (d, f), s, dtype, device),
                    torch.zeros((f,), dtype=dtype, device=device),
                    normal(generator, (f, d), so, dtype, device),
                    torch.zeros((d,), dtype=dtype, device=device))


def gated(p: GatedMLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = x @ p.w_gate
    u = x @ p.w_up
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * u) @ p.w_down


def plain(p: PlainMLP, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    h = x @ p.w_in + p.b_in
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.relu(h)
    return h @ p.w_out + p.b_out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype=torch.bfloat16, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)
