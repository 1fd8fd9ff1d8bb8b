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
tests' oracle).  The reference's sharding hooks: its
``constrain_moe_slots`` places the gathered slots (data, model), which
is what each rank's local slots are under a mesh (``_sharded``: the
routing, the dispatch, the experts' products and the combine run shard
by shard, and no rank gathers another rank's slots); its
``constrain_tokens`` on the output is kept (a no-op without an
``activation_mesh``).  On the
card the gathers' backward scatters with atomics, so gradients through
the dispatch vary in their last bits from run to run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import sharding
from .mlp import normal
from .sharding import constrain_tokens


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
    if sharding._is_dtensor(xg):
        out = _sharded(p, xg, top_k, C, act)
    else:
        slots, slot, keep, gates = _dispatch(p, xg, top_k, C, 0, E)
        y = _experts(slots, p.w_gate, p.w_up, p.w_down, act)
        out = _combine(y, slot, keep, gates, top_k)
    return constrain_tokens(out.reshape(B, S, D))


def _experts(slots: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, act: str) -> torch.Tensor:
    """The batched gated MLP of slots (B', e, C, D) with e experts'
    weights: (B', e, C, D)."""
    g = torch.einsum("becd,edf->becf", slots, w_gate)
    u = torch.einsum("becd,edf->becf", slots, w_up)
    return torch.einsum("becf,efd->becd", _act(g, act) * u, w_down)


def _sharded(p: MoEParams, xg: torch.Tensor, top_k: int, C: int,
             act: str) -> torch.Tensor:
    """``forward``'s groups xg (B', G, D) under a mesh, shard by shard
    (``local_map``).  Each rank routes its batch shard (rows over the
    data axes, whole over ``model``; each sequence routes on its own, so
    this is exact) and gathers the slots of its own experts only: E / m
    of them where the rules split the experts over ``model``, all E where
    they split F.  The dispatch is the same on every ``model`` rank, so a
    rank's experts are a local slice (the placement of the reference's
    ``constrain_moe_slots``, (data, model)), and no rank holds or gathers
    another's slots.  The products run on the local slots (``fsdp``
    expert weights, split over the data axes too, are gathered or
    exchanged: ``_fsdp_experts``), and each rank combines its own
    experts' outputs into a (B', G, D) partial sum over ``model``, which
    the next ``constrain_tokens`` reduces as a row-parallel product's
    output (G D a group, where gathering the outputs moved E C D).  In
    the backward the slots' gradient stays local, the dispatch gather
    becomes a local scatter-add, and x's and the router's gradients are
    partial sums over ``model`` (the router's also over the axes that
    split the batch)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xg.device_mesh
    dp = sharding.dp_axes(mesh)
    xg = sharding.to_spec(xg, [dp, None, None])
    ws = (p.w_gate, p.w_up, p.w_down)
    rep = Replicate()
    x_pl, out, gx, gr = [], [], [], []
    w_pls, g_ws = ([], [], []), ([], [], [])
    for i, (name, xp) in enumerate(zip(mesh.mesh_dim_names, xg.placements)):
        if name in dp:
            x_pl.append(xp)
            out.append(xp)
            gx.append(xp)
            gr.append(Partial() if xp == Shard(0) else rep)
        else:
            # experts or F split over this axis: a partial sum
            split = Partial() if any(isinstance(w.placements[i], Shard)
                                     for w in ws) else rep
            x_pl.append(rep)
            out.append(split)
            gx.append(split)
            gr.append(split)
        for w, pl, g in zip(ws, w_pls, g_ws):
            if name in dp:
                # whole (an fsdp split gathered, unless exchanged below),
                # its gradient a partial sum over a split batch
                pl.append(rep)
                g.append(Partial() if xp == Shard(0) else rep)
            else:
                pl.append(w.placements[i])
                g.append(w.placements[i])
    ex = _fsdp_experts(xg, ws, x_pl, w_pls[0], C)
    if ex is not None:
        i = ex[0][1]
        for w, pl, g in zip(ws, w_pls, g_ws):
            pl[i] = g[i] = w.placements[i]
    ws = [w.redistribute(mesh, tuple(pl)) for w, pl in zip(ws, w_pls)]
    e = ws[0].to_local().shape[0]
    e0 = sharding._local_offset(ws[0], 0)

    def local(xg, w_router, w_gate, w_up, w_down):
        slots, slot, keep, gates = _dispatch(p._replace(w_router=w_router),
                                             xg, top_k, C, e0, e)
        if ex is None:
            y = _experts(slots, w_gate, w_up, w_down, act)
        else:
            y = _exchange_experts(slots, w_gate, w_up, w_down, act, *ex)
        return (_combine(y, slot, keep, gates, top_k, e0),)

    whole = (rep,) * mesh.ndim
    y, = local_map(
        local, out_placements=(tuple(out),),
        in_placements=(tuple(x_pl), whole) + tuple(map(tuple, w_pls)),
        in_grad_placements=(tuple(gx), tuple(gr)) + tuple(map(tuple, g_ws)),
        device_mesh=mesh)(xg, p.w_router.redistribute(mesh, whole), *ws)
    return y


def _fsdp_experts(xg, ws, x_pl, w_pl, C: int):
    """How the expert products meet ``fsdp`` expert weights split over a
    data axis that also splits the batch: None to gather them (the FSDP
    way; their gradients are reduce-scattered back), or ``(group, n, s)``
    to exchange (``_exchange_experts``), as ``sharding.gather_or_exchange``
    names from the bytes each way moves a rank a call: a gather receives n - 1
    shards of each weight; the exchange sends (n - 1) / n of the three
    shards, and of the rank's slots s times over both ways (each expert's
    F is split over s ranks).
    With one sequence a rank (qwen3-moe-235b-a22b's train_4k microbatch,
    and its decode) the slots are small and the weights stay split; with
    16 groups a rank (its 32k prefill) the weights are gathered.  The
    exchange needs one such axis, the weights split along D there, and a
    rank's F divisible by s; otherwise the weights are gathered.  ``w_pl`` is
    w_gate's placements with the data axes gathered."""
    from torch.distributed.tensor import Shard
    mesh = xg.device_mesh
    both = [i for i, xp in enumerate(x_pl)
            if xp == Shard(0) and isinstance(ws[0].placements[i], Shard)]
    if len(both) != 1:
        return None
    i = both[0]
    n = mesh.size(i)
    e = sharding._local_bytes(ws[0].shape[:1], w_pl, mesh, 1)
    s = n // math.gcd(e, n)
    f = ws[0].shape[2]          # F on a rank: split over ``model`` or not
    for j, pl in enumerate(w_pl):
        if pl == Shard(2):
            f //= mesh.size(j)
    if tuple(w.placements[i] for w in ws) != (Shard(1), Shard(1), Shard(2)) \
            or f % s:
        return None
    w_bytes = sum(sharding._local_bytes(w.shape, w.placements, mesh,
                                        w.element_size()) for w in ws)
    rows = sharding._local_bytes(xg.shape[:1], x_pl, mesh, 1)
    slot_bytes = rows * e * C * xg.shape[2] * xg.element_size()
    way = sharding.gather_or_exchange((n - 1) * w_bytes,
                            (n - 1) * (w_bytes + 2 * s * slot_bytes) // n)
    return ((mesh, i), n, s) if way == "exchange" else None


def _exchange_experts(slots, w_gate, w_up, w_down, act: str, group, n: int,
                      s: int) -> torch.Tensor:
    """The expert products with ``fsdp`` weights left split over a data
    axis of n ranks (expert parallelism over that axis).  slots (b, e, C,
    D): this rank's rows for its e experts; w_gate, w_up (e, D / n, F)
    and w_down (e, F, D / n): this rank's slice of D.  Each expert's F is
    cut into s slices, so the e s (expert, slice) pairs fall v = e s / n
    to a rank.  One all-to-all a weight hands each rank its v pairs whole
    along D (as many bytes as its shard); one sends each rank's slots to
    the ranks that own their experts (s copies); the owners run the gated
    MLP on every rank's rows; one returns each rank's rows, and their s
    partial sums over the F slices are added.  Every step is an exchange,
    so the backward is too: the weights' gradients come back to their
    shards whole, and nothing is gathered."""
    b, e, C, D = slots.shape
    f = w_gate.shape[2] // s

    def pairs(w, f_dim):
        # (e, ..., F, ...) -> (e s, ..., F / s, ...): pair (j, t) is j s + t
        return w.unflatten(f_dim, (s, f)).movedim(f_dim, 1).flatten(0, 1)

    wg, wu = (sharding.all_to_all(pairs(w, 2), group, n, 0, 1)
              for w in (w_gate, w_up))                      # (v, D, F / s)
    wd = sharding.all_to_all(pairs(w_down, 1), group, n, 0, 2)  # (v, F/s, D)
    xs = slots[:, :, None].expand(b, e, s, C, D).reshape(b, e * s, C, D)
    xs = sharding.all_to_all(xs, group, n, 1, 0)            # (n b, v, C, D)
    y = sharding.all_to_all(_experts(xs, wg, wu, wd, act), group, n, 0, 1)
    return y.unflatten(1, (e, s)).sum(2)                    # (b, e, C, D)


def _dispatch(p: MoEParams, xg: torch.Tensor, top_k: int, C: int, e0: int,
              e: int):
    """Route groups xg (B', G, D) (through the module's ``route``, which
    reads only ``p.w_router``) and gather the C slots of each of the e
    experts from ``e0`` on (all E without a mesh): returns (slots (B', e,
    C, D), slot (B', G*k), keep (B', G*k), gates (B', G, k)); ``slot``
    numbers all E experts' slots."""
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
    src = src[:, e0 * C:(e0 + e) * C]
    # gathers by ``index_select`` over flattened rows (row b's index i is
    # row b * n + i), which the card runs faster than advanced indexing
    rows = torch.arange(Bp, device=xg.device)[:, None]
    x_pad = torch.cat([xg, xg.new_zeros((Bp, 1, D))], dim=1)
    slots = x_pad.reshape(Bp * (G + 1), D).index_select(
        0, (src + rows * (G + 1)).reshape(-1)).reshape(Bp, e, C, D)
    return slots, slot, keep, gates


def _combine(y: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, top_k: int,
             e0: Optional[int] = None) -> torch.Tensor:
    """The k choices of each token added one after another, each the
    expert output at its slot weighted by its gate (zero if dropped, or
    if its expert is not one of y's e experts from ``e0`` on; ``e0``
    None: y holds all E): y (B', e, C, D) -> (B', G, D)."""
    Bp, e, C, D = y.shape
    G = gates.shape[1]
    rows = torch.arange(Bp, device=y.device)[:, None]
    y_rows = y.reshape(Bp * e * C, D)
    out = torch.zeros((Bp, G, D), dtype=y.dtype, device=y.device)
    local, mine = slot, keep
    if e0 is not None:
        local = slot - e0 * C
        mine = keep & (local >= 0) & (local < e * C)
        local = local.clamp(0, e * C - 1)
    slot_k = (local + rows * (e * C)).reshape(Bp, G, top_k).permute(
        2, 0, 1).reshape(top_k, Bp * G)                       # (k, B'*G)
    w = (gates * mine.reshape(Bp, G, top_k)).to(y.dtype)      # (B', G, k)
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
