"""Mixture-of-Experts layer with capacity-based top-k dispatch.

Counterpart of ``repro.models.lm.moe``, with its design and numerics:

* router: (B, S, D) in f32 @ (D, E) f32 -> the top-k experts of each
  token, sorted by logit with the lower expert first on a tie (as
  ``jax.lax.top_k``; ``torch.topk`` promises no order among ties, so the
  port takes the first k of a stable descending sort), and the softmax
  of the selected logits as gates.
* dispatch: tokens in routing groups of ``min(GROUP, S)`` (a sequence
  that ``GROUP`` does not divide is one group); each group fills E expert
  bins of capacity C = ceil(G k / E cf), at least k.  A (token, choice)'s
  position in its expert is a cumsum over the one-hot of the choices in
  token-major, choice-minor order; positions >= C are dropped (written
  to a dump slot at E*C), unfilled slots read the zero sentinel row G.
  Gathering the slots' tokens gives (B', E, C, D).
* experts: three batched products with the stacked weights (plain large
  products, computed outside any kernel in the reference as here).
* combine: the k choices added one after another, in ``y``'s dtype and
  in the order kk = 0..k-1, each weighted by its gate (zero if dropped).

At decode (S = 1) the capacity is max(ceil(k/E cf), k) = k slots per
expert, so every expert runs k slot rows per sequence: the reference's
design, kept.  ``dense_forward`` runs every expert on every token (the
tests' oracle).  The reference's sharding hooks sit at its places:
``constrain_moe_slots`` on the gathered slots, ``constrain_tokens`` on
the output (no-ops without an ``activation_mesh``).  Under a mesh the
routing, the dispatch gather and the combine run per batch shard
(``sharding.per_batch_shard``: each sequence routes on its own), and the
expert products run on DTensors, experts or F over ``model``.  On the
card the gathers' backward scatters with atomics, so gradients through
the dispatch vary in their last bits from run to run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .mlp import normal
from .sharding import (constrain_moe_slots, constrain_tokens, per_batch_shard,
                       splits_dim)


class MoEParams(NamedTuple):
    w_router: torch.Tensor   # (D, E) float32 for routing stability
    w_gate: torch.Tensor     # (E, D, F)
    w_up: torch.Tensor       # (E, D, F)
    w_down: torch.Tensor     # (E, F, D)


def init(generator: torch.Generator, d: int, f: int, n_experts: int,
         dtype=torch.bfloat16, device="cuda") -> MoEParams:
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return MoEParams(
        w_router=normal(generator, (d, n_experts), s, torch.float32, device),
        w_gate=normal(generator, (n_experts, d, f), s, dtype, device),
        w_up=normal(generator, (n_experts, d, f), s, dtype, device),
        w_down=normal(generator, (n_experts, f, d), so, dtype, device),
    )


def capacity(seq_len: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.25) -> int:
    c = int(math.ceil(seq_len * top_k / n_experts * capacity_factor))
    return max(c, top_k)


def _top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: values sorted descending,
    the lower index first among equal values."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoEParams, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (gates (B,S,k) f32 normalized, experts (B,S,k) int64)."""
    logits = x.to(torch.float32) @ p.w_router
    top_vals, top_idx = _top_k(logits, top_k)
    return torch.softmax(top_vals, dim=-1), top_idx


#: routing-group length: capacity is per contiguous token group, and all
#: dispatch buffers are sized by the group, not the full sequence
GROUP = 4096


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def forward(p: MoEParams, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu") -> torch.Tensor:
    """Capacity-based top-k MoE; x (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E = p.w_router.shape[1]
    G = min(GROUP, S)
    n_g = S // G if S % G == 0 else 1
    if S % G != 0:
        G = S
    Bp = B * n_g
    xg = x.reshape(Bp, G, D)
    C = capacity(G, E, top_k, capacity_factor)
    slots, slot, keep, gates = per_batch_shard(
        lambda xg, w_router: _dispatch(p._replace(w_router=w_router), xg,
                                       top_k, C), (xg,), (p.w_router,),
        n_out=4)
    slots = constrain_moe_slots(slots)

    # --- experts: batched gated MLP ---------------------------------------
    g = torch.einsum("becd,edf->becf", slots, p.w_gate)
    u = torch.einsum("becd,edf->becf", slots, p.w_up)
    h = _act(g, act) * u
    if splits_dim(h, 1):
        # experts split over ``model``: the shards are expert-major in
        # memory while DTensor reasons about the global strides, and the
        # next einsum's view of them fails; a contiguous copy agrees
        h = h.contiguous()
    y = torch.einsum("becf,efd->becd", h, p.w_down)

    out, = per_batch_shard(lambda *a: (_combine(*a, top_k),),
                           (y, slot, keep, gates), n_out=1)
    return constrain_tokens(out.reshape(B, S, D))


def _dispatch(p: MoEParams, xg: torch.Tensor, top_k: int, C: int):
    """Route groups xg (B', G, D) (through the module's ``route``, which
    reads only ``p.w_router``) and gather each expert's C slots: returns
    (slots (B', E, C, D), slot (B', G*k), keep (B', G*k), gates (B', G,
    k))."""
    Bp, G, D = xg.shape
    E = p.w_router.shape[1]
    gates, experts = route(p, xg, top_k)                      # (B',G,k)

    # --- position of each (token, choice) within its expert --------------
    flat_e = experts.reshape(Bp, G * top_k)                   # (B', G*k)
    # the one-hot expert-major, so the cumsum runs along its last axis
    # (an exact integer sum either way; along a middle axis PyTorch's CUDA
    # scan runs serially in that axis's length)
    onehot = F.one_hot(flat_e, E).to(torch.int32).transpose(1, 2)
    before = torch.cumsum(onehot.contiguous(), dim=-1, dtype=torch.int32) \
        - onehot                                              # (B', E, G*k)
    pos = torch.gather(before, 1, flat_e[:, None, :])[:, 0]
    keep = pos < C                                            # (B', G*k)

    # --- per-slot source token: scatter small indices, gather tokens ------
    slot = flat_e * C + torch.where(keep, pos, 0)
    token_idx = torch.arange(G * top_k, device=xg.device) // top_k
    src = torch.full((Bp, E * C + 1), G, dtype=torch.int64, device=xg.device)
    src.scatter_(1, torch.where(keep, slot, E * C),
                 torch.where(keep, token_idx[None, :], G))
    src = src[:, :E * C]
    # gathers by ``index_select`` over flattened rows (row b's index i is
    # row b * n + i), which the card runs faster than advanced indexing
    rows = torch.arange(Bp, device=xg.device)[:, None]
    x_pad = torch.cat([xg, xg.new_zeros((Bp, 1, D))], dim=1)
    slots = x_pad.reshape(Bp * (G + 1), D).index_select(
        0, (src + rows * (G + 1)).reshape(-1)).reshape(Bp, E, C, D)
    return slots, slot, keep, gates


def _combine(y: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, top_k: int) -> torch.Tensor:
    """The k choices of each token added one after another, each the
    expert output at its slot weighted by its gate (zero if dropped):
    y (B', E, C, D) -> (B', G, D)."""
    Bp, E, C, D = y.shape
    G = gates.shape[1]
    rows = torch.arange(Bp, device=y.device)[:, None]
    y_rows = y.reshape(Bp * E * C, D)
    out = torch.zeros((Bp, G, D), dtype=y.dtype, device=y.device)
    slot_k = (slot + rows * (E * C)).reshape(Bp, G, top_k).permute(2, 0, 1)
    slot_k = slot_k.reshape(top_k, Bp * G)                    # (k, B'*G)
    w = (gates * keep.reshape(Bp, G, top_k)).to(y.dtype)      # (B', G, k)
    for kk in range(top_k):
        yk = y_rows.index_select(0, slot_k[kk]).reshape(Bp, G, D)
        out = out + yk * w[:, :, kk, None]
    return out


def dense_forward(p: MoEParams, x: torch.Tensor, top_k: int,
                  act: str = "silu") -> torch.Tensor:
    """Reference: run every expert on every token (oracle for tests)."""
    B, S, D = x.shape
    E = p.w_router.shape[1]
    gates, experts = route(p, x, top_k)
    dense_gates = torch.zeros((B, S, E), dtype=torch.float32, device=x.device)
    dense_gates = dense_gates.scatter(-1, experts, gates)
    g = torch.einsum("bsd,edf->bsef", x, p.w_gate)
    u = torch.einsum("bsd,edf->bsef", x, p.w_up)
    y = torch.einsum("bsef,efd->bsed", _act(g, act) * u, p.w_down)
    return torch.einsum("bsed,bse->bsd", y, dense_gates.to(y.dtype))
