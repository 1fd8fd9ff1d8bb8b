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
from .sharding import constrain_tokens, matmul, pad


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


def _in_proj(w_in: torch.Tensor, x: torch.Tensor, Di: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) @ w_in (D, 2 Di) -> (xs, z), each (B, S, Di).

    Under a mesh, ``w_in``'s columns are split over ``model``, so a rank's
    product holds whole blocks of xs (the first half of the ranks) or of z
    (the second half), where xs and z must each end split over ``model``.
    Of the two ways to get there, ``sharding.gather_or_exchange`` takes
    the one that moves fewer bytes a rank a call: gather the weight (D x 2
    Di; the gather receives its m - 1 other shards), or compute the local
    column block and exchange its two Di / m halves with the ranks that
    own them (one all-to-all of the rank's B / dp x S tokens, GSPMD's
    permute of the activations; it sends (m - 1) / m of the two halves).
    The weight is gathered only where that moves strictly fewer bytes: at
    a tie (falcon-mamba's prefill of 2 x 32,768 tokens a rank) the halves
    are exchanged, as GSPMD keeps the weight split.  Neither slices the
    product across its split, which would gather it whole."""
    if not sharding.splits_dim(w_in, 1):
        xz = x @ w_in
        return xz[..., :Di], xz[..., Di:]
    mesh = w_in.device_mesh
    m = sharding.mesh_axes(mesh)["model"]
    x = sharding.to_spec(x, [sharding.dp_axes(mesh), None, None])
    w = sharding.to_spec(w_in, [None, "model"])
    tokens = x.to_local().shape[0] * x.shape[1]
    halves = tokens * 2 * Di // m * x.element_size()
    shard = w.shape[0] * w.shape[1] // m * w.element_size()
    if Di % m or sharding.gather_or_exchange(
            (m - 1) * shard, (m - 1) * halves // m) == "gather":
        w = sharding.to_spec(w, [None, None])
        return tuple(x @ sharding.to_spec(h, [None, "model"])
                     for h in (w[:, :Di], w[:, Di:]))
    return _exchange_halves(x, w, Di)


def _exchange_halves(x, w, Di: int):
    """``_in_proj``'s exchange: rank r of the ``model`` axis (size m) holds
    w's column blocks 2r and 2r + 1 (each Di / m wide; block g < m is
    xs's shard g, block g >= m is z's shard g - m) and sends block g to
    rank g mod m, so rank r receives xs's shard r from rank r // 2 and
    z's shard r from rank (m + r) // 2, in that order."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    mdim = mesh.mesh_dim_names.index("model")
    m = mesh.size(mdim)
    r = mesh.get_coordinate()[mdim]
    dest = [(2 * r + c) % m for c in (0, 1)]
    order = sorted((0, 1), key=lambda c: dest[c])
    send = [dest.count(d) for d in range(m)]
    recv = [int(s == r // 2) + int(s == (m + r) // 2) for s in range(m)]

    def local(x, w):
        y = (x @ w).unflatten(-1, (2, Di // m)).movedim(-2, 0)
        got = funcol.all_to_all_single_autograd(
            y[order].contiguous(), recv, send, (mesh, mdim))
        # copies, which wait for the collective: views of its pending
        # result would be read before it lands (in the backward too)
        return got[0].clone(), got[1].clone()

    out = tuple(Shard(2) if i == mdim else pl
                for i, pl in enumerate(x.placements))
    gx = tuple(Partial() if i == mdim else pl
               for i, pl in enumerate(x.placements))
    gw = tuple(Shard(1) if i == mdim else
               Partial() if isinstance(pl, Shard) else Replicate()
               for i, pl in enumerate(x.placements))
    return local_map(local, out_placements=(out, out),
                     in_placements=(x.placements, w.placements),
                     in_grad_placements=(gx, gw), device_mesh=mesh)(x, w)


def forward(p: SSMParams, x: torch.Tensor, state: Optional[SSMState] = None
            ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence pass (training/prefill); x (B,S,D)."""
    S = x.shape[1]
    Di = p.conv_b.shape[0]
    N = p.a_log.shape[1]
    xs, z = _in_proj(p.w_in, x, Di)
    tail_src = xs
    if state is not None:
        ctx = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
        conv_out = _causal_depthwise_conv(ctx, p.conv_w, p.conv_b)[:, -S:]
    else:
        conv_out = _causal_depthwise_conv(xs, p.conv_w, p.conv_b)
    xs = F.silu(conv_out)
    # under a mesh the products run shard by shard (``sharding.matmul``;
    # DTensor's own backward of them gathers w_out and the tokens), and
    # those over the split Di are partial sums: the small (B, S, R) one is
    # reduced before the second product (DTensor cannot feed a partial sum
    # into it on some PyTorch releases), B and C before the scan's
    # in-place state fold
    low = constrain_tokens(matmul(xs, p.w_dt_down))
    pre = matmul(low, p.w_dt_up) + p.dt_bias.to(torch.float32)
    dt = torch.logaddexp(pre, torch.zeros_like(pre))     # jax.nn.softplus
    bc = constrain_tokens(matmul(xs, p.w_bc))
    bmat, cmat = bc[..., :N], bc[..., N:]
    h0 = state.h if state is not None else None
    y, h_last = _ssm_scan(dt, bmat, cmat, xs, p.a_log, h0)
    y = y + xs * p.d_skip
    y = y * F.silu(z)
    out = matmul(y, p.w_out)
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
