"""Mamba-1 selective state-space block (falcon-mamba-7b).

Counterpart of ``repro.models.lm.ssm``.  Structure per block (Gu & Dao
2023, falcon-mamba variant):

  in_proj: D -> 2*Di (x, z gate)
  depthwise causal conv1d (kernel 4) + SiLU on x
  selective SSM: per-channel state (Di, N); data-dependent dt, B, C:
     dt = softplus(x @ W_dt_down @ W_dt_up + bias)   (via dt_rank)
     B, C = x @ W_B, x @ W_C                         (Di -> N each)
     h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t * x_t
     y_t = (C_t . h_t) + D_skip * x_t
  gate: y * silu(z); out_proj: Di -> D

Training and prefill solve the recurrence with ``scan.linear_scan`` (the
reference's ``associative_scan``, at log depth in S), in f32.  The
reference's dtypes are kept step by step: the causal conv adds its taps
one after another in bf16 (``F.conv1d`` would sum in f32 and round
once); dt is the two bf16 products, then ``+ dt_bias`` in f32, then
softplus in f32 as ``logaddexp(x, 0)`` (``F.softplus`` returns x above
20); y is rounded to bf16 before ``+ xs * d_skip`` and ``* silu(z)``.  A
carried state folds into the first step's u.  Decode keeps (conv tail,
h) and runs the same pass on one token.  The returned state is a copy,
so it does not hold the (B, S, Di, N) scan tensors alive.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .mlp import normal
from .scan import linear_scan
from . import sharding
from .sharding import constrain_tokens, pad


class SSMParams(NamedTuple):
    w_in: torch.Tensor        # (D, 2*Di)
    conv_w: torch.Tensor      # (K, Di) depthwise
    conv_b: torch.Tensor      # (Di,)
    w_dt_down: torch.Tensor   # (Di, R)
    w_dt_up: torch.Tensor     # (R, Di)
    dt_bias: torch.Tensor     # (Di,)
    w_bc: torch.Tensor        # (Di, 2*N)
    a_log: torch.Tensor       # (Di, N) — A = -exp(a_log)
    d_skip: torch.Tensor      # (Di,)
    w_out: torch.Tensor       # (Di, D)


class SSMState(NamedTuple):
    conv: torch.Tensor        # (B, K-1, Di) last inputs
    h: torch.Tensor           # (B, Di, N)


def init(generator: torch.Generator, d: int, d_inner: int, n_state: int,
         dt_rank: int, conv_k: int = 4, dtype=torch.bfloat16,
         device="cuda") -> SSMParams:
    s = 1.0 / math.sqrt(d)
    si = 1.0 / math.sqrt(d_inner)
    states = torch.arange(1, n_state + 1, dtype=torch.float32, device=device)
    return SSMParams(
        w_in=normal(generator, (d, 2 * d_inner), s, dtype, device),
        conv_w=normal(generator, (conv_k, d_inner), 0.2, dtype, device),
        conv_b=torch.zeros((d_inner,), dtype=dtype, device=device),
        w_dt_down=normal(generator, (d_inner, dt_rank), si, dtype, device),
        w_dt_up=normal(generator, (dt_rank, d_inner),
                       1.0 / math.sqrt(dt_rank), dtype, device),
        dt_bias=torch.full((d_inner,), -4.0, dtype=dtype, device=device),
        w_bc=normal(generator, (d_inner, 2 * n_state), si, dtype, device),
        a_log=torch.log(states.tile((d_inner, 1))),
        d_skip=torch.ones((d_inner,), dtype=dtype, device=device),
        w_out=normal(generator, (d_inner, d), si, dtype, device),
    )


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """x (B,S,Di), w (K,Di): causal depthwise conv along S, the taps added
    one after another in x's dtype."""
    K = w.shape[0]
    xp = pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _ssm_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
              xin: torch.Tensor, a_log: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan over S.

    dt (B,S,Di), bmat/cmat (B,S,N), xin (B,S,Di), a_log (Di,N).
    Returns y (B,S,Di) in xin's dtype and the final state (B,Di,N) f32.

    Recurrence per (channel i, state n):
        h_t = exp(-exp(a_log) * dt_t) * h_{t-1} + dt_t * B_t[n] * x_t
    """
    A = -torch.exp(a_log.to(torch.float32))                     # (Di,N)
    dt32 = dt.to(torch.float32)
    g = torch.exp(dt32[..., None] * A)                          # (B,S,Di,N)
    u = (dt32 * xin.to(torch.float32))[..., None] * \
        bmat.to(torch.float32)[:, :, None, :]                   # (B,S,Di,N)
    if h0 is not None:
        # fold the carried state into the first step's u
        u[:, 0] += g[:, 0] * h0.to(torch.float32)
    hs = linear_scan(g, u, dim=1)
    del g, u
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat.to(torch.float32))
    return y.to(xin.dtype), hs[:, -1].clone()


def forward(p: SSMParams, x: torch.Tensor, state: Optional[SSMState] = None
            ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence pass (training/prefill); x (B,S,D)."""
    S = x.shape[1]
    Di = p.conv_b.shape[0]
    N = p.a_log.shape[1]
    if sharding.splits_dim(p.w_in, 1) and \
            x.shape[0] * x.shape[1] >= p.w_in.shape[0]:
        # the x and z columns split over model as separate weights: slicing
        # the product across its split gathers the (B, S, 2 Di) product
        # onto every rank, gathering the weight moves (D, 2 Di); over a
        # sequence (B S >= D tokens) the weight is the smaller
        w = sharding.to_spec(p.w_in, [None, None])
        xs, z = (x @ sharding.to_spec(h, [None, "model"])
                 for h in (w[:, :Di], w[:, Di:]))
    else:
        xz = x @ p.w_in
        xs, z = xz[..., :Di], xz[..., Di:]
    tail_src = xs
    if state is not None:
        ctx = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
        conv_out = _causal_depthwise_conv(ctx, p.conv_w, p.conv_b)[:, -S:]
    else:
        conv_out = _causal_depthwise_conv(xs, p.conv_w, p.conv_b)
    xs = F.silu(conv_out)
    pre = (xs @ p.w_dt_down) @ p.w_dt_up + p.dt_bias.to(torch.float32)
    dt = torch.logaddexp(pre, torch.zeros_like(pre))     # jax.nn.softplus
    # under a mesh the product over the split Di is a partial sum: reduce it
    # here (B and C are small), before the scan's in-place state fold
    bc = constrain_tokens(xs @ p.w_bc)
    bmat, cmat = bc[..., :N], bc[..., N:]
    h0 = state.h if state is not None else None
    y, h_last = _ssm_scan(dt, bmat, cmat, xs, p.a_log, h0)
    y = y + xs * p.d_skip
    y = y * F.silu(z)
    out = y @ p.w_out
    K = p.conv_w.shape[0]
    if state is not None:
        ctx_tail = torch.cat([state.conv.to(tail_src.dtype), tail_src], dim=1)
    else:
        ctx_tail = pad(tail_src, (0, 0, K - 1, 0))
    return out, SSMState(conv=ctx_tail[:, -(K - 1):].clone(), h=h_last)


def init_state(batch: int, d_inner: int, n_state: int, conv_k: int = 4,
               dtype=torch.bfloat16, device="cuda") -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype, device=device),
        h=torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                      device=device),
    )


def decode_step(p: SSMParams, x: torch.Tensor, state: SSMState
                ) -> Tuple[torch.Tensor, SSMState]:
    """One-token decode; x (B,1,D)."""
    return forward(p, x, state)
