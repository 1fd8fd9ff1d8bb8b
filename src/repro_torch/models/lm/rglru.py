"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.lm.rglru``.  Recurrent block structure (per
Griffin):
  two branches from x:
    branch 1: linear D->Di, GeLU
    branch 2: linear D->Di, causal depthwise conv1d (k=4), RG-LRU
  merge: elementwise product, linear Di->D.

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
  a_t = a^(c * r_t)            with a = sigmoid(Lambda), c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The first-order recurrence runs through ``scan.linear_scan`` in f32, as
the SSM block's does.  GeLU is the tanh approximation (``jax.nn.gelu``'s
default), and ``sqrt(max(1 - a^2, 1e-12))`` keeps the reference's clamp.
The causal conv adds its taps one after another in bf16.  The returned
state is a copy, so it does not hold the sequence's tensors alive.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .mlp import normal
from .scan import linear_scan
from .sharding import constrain, pad

_C = 8.0


class RGLRUParams(NamedTuple):
    w_x: torch.Tensor       # (D, Di)  branch-2 input proj
    w_y: torch.Tensor       # (D, Di)  branch-1 (gelu gate) proj
    conv_w: torch.Tensor    # (K, Di)
    conv_b: torch.Tensor    # (Di,)
    w_r: torch.Tensor       # (Di, Di) recurrence gate (block-diag in the
    w_i: torch.Tensor       # (Di, Di) paper; dense here)
    lam: torch.Tensor       # (Di,)    Lambda
    w_out: torch.Tensor     # (Di, D)


class RGLRUState(NamedTuple):
    conv: torch.Tensor      # (B, K-1, Di)
    h: torch.Tensor         # (B, Di) f32


def init(generator: torch.Generator, d: int, d_inner: int, conv_k: int = 4,
         dtype=torch.bfloat16, device="cuda") -> RGLRUParams:
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_inner)
    return RGLRUParams(
        w_x=normal(generator, (d, d_inner), s, dtype, device),
        w_y=normal(generator, (d, d_inner), s, dtype, device),
        conv_w=normal(generator, (conv_k, d_inner), 0.2, dtype, device),
        conv_b=torch.zeros((d_inner,), dtype=dtype, device=device),
        w_r=normal(generator, (d_inner, d_inner), si, dtype, device),
        w_i=normal(generator, (d_inner, d_inner), si, dtype, device),
        lam=torch.full((d_inner,), 2.0, dtype=torch.float32, device=device),
        w_out=normal(generator, (d_inner, d), si, dtype, device),
    )


def _split_di(t: torch.Tensor) -> torch.Tensor:
    """Under a mesh, the gate pre-activations (B, S, Di), partial sums over
    the split Di, reduced to batch over data and Di over ``model`` (a
    reduce-scatter; left partial, DTensor splits the sequence instead)."""
    return constrain(t, lambda mesh, dp: [dp, None, "model"])


def _causal_conv(x, w, b):
    K = w.shape[0]
    xp = pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                lam: torch.Tensor, h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/r/i (B,S,Di) -> y (B,S,Di) in x's dtype, final h (B,Di) f32."""
    a_base = torch.sigmoid(lam)                               # (Di,)
    log_a = _C * r.to(torch.float32) * torch.log(a_base)      # (B,S,Di)
    a = torch.exp(log_a)
    gated = i.to(torch.float32) * x.to(torch.float32)
    u = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated
    if h0 is not None:
        u[:, 0] += a[:, 0] * h0
    hs = linear_scan(a, u, dim=1)
    return hs.to(x.dtype), hs[:, -1].clone()


def forward(p: RGLRUParams, x: torch.Tensor,
            state: Optional[RGLRUState] = None
            ) -> Tuple[torch.Tensor, RGLRUState]:
    S = x.shape[1]
    y_gate = F.gelu((x @ p.w_y).to(torch.float32), approximate="tanh").to(x.dtype)
    xs = x @ p.w_x
    if state is not None:
        ctx = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
        conv_out = _causal_conv(ctx, p.conv_w, p.conv_b)[:, -S:]
    else:
        conv_out = _causal_conv(xs, p.conv_w, p.conv_b)
    r = torch.sigmoid(_split_di(conv_out @ p.w_r).to(torch.float32))
    i = torch.sigmoid(_split_di(conv_out @ p.w_i).to(torch.float32))
    h0 = state.h if state is not None else None
    y, h_last = _rglru_scan(conv_out, r, i, p.lam, h0)
    out = (y * y_gate) @ p.w_out
    K = p.conv_w.shape[0]
    if state is not None:
        ctx_tail = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
    else:
        ctx_tail = pad(xs, (0, 0, K - 1, 0))
    return out, RGLRUState(conv=ctx_tail[:, -(K - 1):].clone(), h=h_last)


def init_state(batch: int, d_inner: int, conv_k: int = 4, dtype=torch.bfloat16,
               device="cuda") -> RGLRUState:
    return RGLRUState(
        conv=torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype, device=device),
        h=torch.zeros((batch, d_inner), dtype=torch.float32, device=device))
