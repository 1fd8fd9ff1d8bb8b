"""Grouped-query attention with the variants the assigned archs need:

* GQA / MQA / MHA (``n_kv_heads`` divides ``n_heads``)
* causal masking; sliding-window (local) masking with a per-layer window
  (``GLOBAL_WINDOW`` means global attention), for mixed local/global
  stacks (gemma2/gemma3)
* attention-logit softcapping (gemma2)
* cross-attention (whisper decoder)
* training (full sequence, differentiable), prefill (full sequence) and
  single-token decode against a KV cache

Counterpart of ``repro.models.lm.attention``, with its shapes: hidden
(B, S, D); q/k/v (B, S, H, hd); caches (B, S_max, KV, hd).  Two routes
for a full sequence, chosen by the caller and never by a ``try``:

* ``forward_train`` is the reference's ``forward`` as it trains: K/V
  expanded to H heads and the plain ``attend`` under the full mask, or,
  from ``CHUNK_THRESHOLD`` tokens, over query chunks of ``Q_CHUNK`` (a
  Python loop with the values of the reference's ``lax.scan``).  The flash
  kernel has no backward, in the reference as here, so training never
  reaches it.
* ``forward`` (prefill) sends q/k/v through ``kernels.ops.attention``
  (the flash kernel on the card, its plain version on the CPU), the
  drop-in that the reference names for its hot path; with it, memory is
  O(S) at any length.

Decode (one query against the cache) stays plain PyTorch, as the
reference computes it with ``attend``.  So does cross-attention
(``kv_from``, and ``cross_decode``): the reference sends it through the
plain ``attend`` with no rope and no mask, never to the flash kernel,
whose queries and keys share one length.

The reference's sharding hooks sit at its places: ``_pad_heads`` (on
the projections' weights here) and ``_constrain_attn`` in every
full-sequence route (no-ops without an ``activation_mesh``).  Under a
mesh the prefill runs the kernel shard by shard (``_flash``, through
``local_map``): batch over the data axes, heads over ``model``.  The
kernel maps query head h to KV head ``h // (H / KV)``, which holds
within each shard when both H and KV divide the model axis; otherwise
K/V are expanded to H heads first, as the reference always does.
Padded heads stay split through ``wo`` (padded with zero rows), so the
output projection is the row-parallel partial sum the reference's is,
and no rank gathers the heads to slice them off.  Rope tables and masks
built here become replicated DTensors when their operands are DTensors
(``sharding.replicate_like``), and a decode step writes its K/V into
the (possibly sequence-sharded) cache with ``sharding.write_slot`` and
attends over it where it lies (``_attend_cache``): each rank over its
own sequence shard, the softmax reduced across shards, as GSPMD does
for the reference's rule "decode attention reduces over S with
collectives".
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...kernels import ops
from . import rope, sharding
from .mlp import normal
from .sharding import constrain, constrain_tokens, replicate_like


def _pad_heads(wq, wk, wv):
    """Zero-pad the head axis to the next multiple of the model-axis size
    so attention shards by head, as the reference does.

    The port pads the projections' weights (D, heads, hd) where the
    reference pads q/k/v: padded q heads get zero weights, so they are
    zero and see zero k/v, their output is zero and ``wo`` gets zero rows
    for them (``_out_proj_padded``): numerics are untouched; the cost is
    (H_pad/H - 1) extra attention FLOPs.  K/V weights are first expanded
    to H heads unless H and KV both divide the model axis (then the
    kernel's head-group map holds within each shard).  The padded weights
    are split by head over ``model``, so q/k/v are born split, each rank
    projects only its own heads, and the projections' input gradient is
    a partial sum over ``model`` (one all-reduce of the tokens, as GSPMD
    reduces the reference's), where padding the activations and then
    splitting them would gather every head's gradient onto every rank.
    Under a mesh each rank builds only its own slice of the padded heads
    (``_head_slice``), from the rows it holds.  Without an activation
    mesh nothing changes.  Returns (wq, wk, wv, real_H).
    """
    mesh = sharding._ACT_MESH.get()
    H = wq.shape[1]
    if mesh is None:
        return wq, wk, wv, H
    m = sharding.mesh_axes(mesh)["model"]
    if H % m == 0 and wk.shape[1] % m == 0:
        return wq, wk, wv, H
    if not sharding._is_dtensor(wq):
        wk, wv = (torch.repeat_interleave(w, H // w.shape[1], dim=1)
                  for w in (wk, wv))
        z = (0, 0, 0, (-H) % m)
        return F.pad(wq, z), F.pad(wk, z), F.pad(wv, z), H
    if H % m:
        wq = _head_slice(wq, 1, H)
    return wq, _head_slice(wk, 1, H), _head_slice(wv, 1, H), H


def _head_slice(w, dim: int, n_heads: int):
    """DTensor ``w`` with its head axis ``dim`` (``w.shape[dim]`` heads,
    not split over ``model``: the rules split no head count that the axis
    does not divide, and K/V heads that divide it come with q heads that
    do) made ``n_heads`` heads, K/V heads repeated in groups of ``n_heads
    / w.shape[dim]``, then zero-padded to a multiple of the model axis and
    split over it, each rank building only its own slice of the padded
    heads (real heads copied, padding heads zeros) from the rows it holds:
    no rank gathers the weight, and its gradient is a partial sum over
    ``model`` (each rank's slice covers only its own heads), where
    splitting a padded weight whole would gather the padded gradient onto
    every rank."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    mdim = mesh.mesh_dim_names.index("model")
    m = mesh.size(mdim)
    per = (n_heads + (-n_heads) % m) // m
    lo = mesh.get_coordinate()[mdim] * per
    group = n_heads // w.shape[dim]
    src = torch.arange(lo, min(lo + per, n_heads)) // group

    def local(t):
        t = t.index_select(dim, src.to(t.device))
        widths = [0, 0] * (t.ndim - 1 - dim) + [0, per - src.numel()]
        return (F.pad(t, widths),)

    out, = local_map(
        local, out_placements=(tuple(
            Shard(dim) if i == mdim else pl
            for i, pl in enumerate(w.placements)),),
        in_placements=(w.placements,),
        in_grad_placements=(tuple(
            Partial() if i == mdim else pl
            for i, pl in enumerate(w.placements)),),
        device_mesh=mesh)(w)
    return out


def _constrain_attn(q, k, v):
    """Pin attention activation sharding: batch over data, heads over
    'model' (head counts are pre-padded to divide the axis)."""
    def spec(mesh, dp):
        if q.shape[2] % sharding.mesh_axes(mesh)["model"] == 0:
            return [dp, None, "model", None]
        return [dp, None, None, None]

    return constrain(q, spec), constrain(k, spec), constrain(v, spec)


def _per_shard(fn, q, k, v):
    """``fn(q, k, v)`` over (B, S, heads, hd) tensors.  DTensors run it
    shard by shard with ``local_map``: batch over the data axes, heads over
    ``model`` where both q's and k's head counts divide it (then query head
    h of a shard still reads KV head ``h // (H / KV)`` of that shard), the
    sequence whole (a cache split along its sequence goes to
    ``_attend_cache`` instead)."""
    if not sharding._is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    m = sharding.mesh_axes(mesh)["model"]
    heads = "model" if q.shape[2] % m == 0 and k.shape[2] % m == 0 else None
    spec = [sharding.dp_axes(mesh), None, heads, None]
    q, k, v = (sharding.to_spec(t, spec) for t in (q, k, v))
    out, = local_map(lambda *a: (fn(*a),), out_placements=(q.placements,),
                     in_placements=(q.placements, k.placements, v.placements),
                     device_mesh=mesh)(q, k, v)
    return out


def _flash(q, k, v, **kw):
    """``ops.attention`` over (B, S, heads, hd) q/k/v, result (B, S, H, hd)
    f32; on DTensors the kernel launches on each rank's shard
    (``_per_shard``)."""
    return _per_shard(lambda q, k, v: ops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2), q, k, v)


def _attend_kv(q, k, v, bias, softcap, scale):
    """``attend`` with K/V expanded to q's heads first; on DTensors shard
    by shard (``_per_shard``), with ``bias`` a plain (1, 1, Sq, Sk)
    tensor."""
    def local(q, k, v):
        H = q.shape[2]
        return attend(q, _expand_kv(k, H), _expand_kv(v, H), bias, softcap,
                      scale)
    return _per_shard(local, q, k, v)


def _attend_cache(q, k, v, bias, softcap, scale):
    """``_attend_kv`` of q (B, Sq, H, hd) over a cache k/v (B, S_max, KV,
    hd), ``bias`` a plain (1, 1, Sq, S_max) tensor or None.  Where DTensor
    splits the cache's sequence over mesh axes, the cache is never
    gathered: each rank computes, over its own sequence shard, the row
    max, the exponentials and the partial P.V; the max is all-reduced
    first, then the sum of exponentials and the f32 P.V (functional
    collectives inside ``local_map``), so the probabilities are the global
    softmax, cast to v's dtype before P.V as in ``attend``.  q's batch and
    heads follow the cache's split of its own; its sequence is whole."""
    if not sharding.splits_dim(k, 1):
        return _attend_kv(q, k, v, bias, softcap, scale)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    seq = [i for i, pl in enumerate(k.placements)
           if isinstance(pl, Shard) and pl.dim == 1]
    q_pl = tuple(Replicate() if i in seq else pl
                 for i, pl in enumerate(k.placements))
    bias_pl = tuple(Shard(3) if i in seq else Replicate()
                    for i in range(mesh.ndim))
    if bias is None:
        bias = torch.zeros((1, 1, q.shape[1], k.shape[1]), device=q.device)
    q = q.redistribute(mesh, q_pl)
    v = v.redistribute(mesh, k.placements)
    bias = replicate_like(bias, k).redistribute(mesh, bias_pl)

    def reduce(t, op):
        for i in seq:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    def local(q, k, v, bias):
        H = q.shape[2]
        k, v = _expand_kv(k, H), _expand_kv(v, H)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
            * scale
        if softcap is not None:
            logits = torch.tanh(logits / softcap) * softcap
        logits = logits + bias
        e = torch.exp(logits - reduce(logits.amax(-1, keepdim=True), "max"))
        probs = (e / reduce(e.sum(-1, keepdim=True), "sum")).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return (reduce(out.to(torch.float32), "sum").to(v.dtype),)

    out, = local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, k.placements, k.placements,
                                    bias_pl),
                     device_mesh=mesh)(q, k, v, bias)
    return out


class AttnParams(NamedTuple):
    wq: torch.Tensor      # (D, H, hd)
    wk: torch.Tensor      # (D, KV, hd)
    wv: torch.Tensor      # (D, KV, hd)
    wo: torch.Tensor      # (H, hd, D)


def init(generator: torch.Generator, d_model: int, n_heads: int, n_kv: int,
         head_dim: int, dtype=torch.bfloat16, device="cuda") -> AttnParams:
    s = 1.0 / math.sqrt(d_model)
    so = 1.0 / math.sqrt(n_heads * head_dim)
    return AttnParams(
        wq=normal(generator, (d_model, n_heads, head_dim), s, dtype, device),
        wk=normal(generator, (d_model, n_kv, head_dim), s, dtype, device),
        wv=normal(generator, (d_model, n_kv, head_dim), s, dtype, device),
        wo=normal(generator, (n_heads, head_dim, d_model), so, dtype, device),
    )


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating groups."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive attention bias (Sq, Sk) from causal + sliding-window rules
    (a huge ``window`` means global attention)."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, -1e30).to(torch.float32)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor], softcap: Optional[float],
           scale: float) -> torch.Tensor:
    """Core softmax attention; q (B,Sq,H,hd), k/v (B,Sk,H,hd).  Logits in
    f32 after an einsum in the inputs' dtype; probabilities cast to v's
    dtype before P.V, as in the reference."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, D) -> (B, S, D).  ``einsum`` contracts
    (hd, H) with H innermost; where DTensor splits the heads of either
    operand over a mesh axis that ordering makes a strided shard, which
    DTensor's product cannot take under fake tensors, so a split operand
    goes through one (H hd) contraction instead (the same sum in another
    order), by ``sharding.matmul``'s rules (an ``fsdp`` ``wo``, D split
    over the data axes, is gathered or kept split by
    ``gather_or_exchange``).  That product leaves a partial sum over the
    model axis, which is reduced here, batch over the data axes (the
    row-parallel all-reduce): left partial, DTensor would split the
    following norm along the sequence instead."""
    if sharding.splits_dim(out, 2) or sharding.splits_dim(wo, 0):
        B, S, H, hd = out.shape
        return constrain_tokens(sharding.matmul(
            out.reshape(B, S, H * hd), wo.reshape(H * hd, wo.shape[2])))
    return torch.einsum("bqhd,hdk->bqk", out, wo)


def _project(x: torch.Tensor, *ws: torch.Tensor) -> list:
    """(B, S, D) x each (D, heads, hd) of ``ws`` -> a list of (B, S, heads,
    hd).  Where DTensor splits an operand the products run shard by
    shard, by ``sharding.matmuls``'s rules (the same ``einsum`` on each
    shard; DTensor's own propagation through it splits column counts that
    the heads cannot unflatten): x with its batch over the data axes and
    D whole elsewhere, placed once for all the products, so that its
    gradient (a partial sum over ``model`` where the heads split) is
    reduced once; heads split over ``model`` stay split.  Where w's D is
    split over an axis that also splits the batch (an ``fsdp`` weight),
    ``sharding.gather_or_exchange`` decides: at decode the rows move and w
    stays split, at training w is gathered.  Where it is split over an
    axis that does not split the batch (an ``fsdp`` weight at batch 1), w
    stays split: x is sliced along D to match, each rank contracts its slice,
    and the small product is summed over that axis here, as GSPMD does,
    instead of gathering the weight."""
    def local(x, w):
        return torch.einsum("bsd,dhk->bshk", x, w)

    if not (sharding.splits_any(x) or any(map(sharding.splits_any, ws))):
        return [local(x, w) for w in ws]
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    x = sharding.to_spec(x, [sharding.dp_axes(mesh), None, None])
    return [y.redistribute(mesh, tuple(
        Replicate() if isinstance(pl, Partial) else pl
        for pl in y.placements))
        if any(isinstance(pl, Partial) for pl in y.placements) else y
        for y in sharding.matmuls(x, ws, local)]


#: sequences at least this long use q-chunked attention (bounded memory)
CHUNK_THRESHOLD = 8192
Q_CHUNK = 1024


def _cross(p: AttnParams, x: torch.Tensor, kv_from: torch.Tensor,
           softcap: Optional[float]) -> torch.Tensor:
    """Cross-attention of x (B, S, D) over ``kv_from`` (B, S_enc, D): no
    rope, no mask, the plain ``attend``."""
    hd = p.wq.shape[2]
    wq, wk, wv, real_h = _pad_heads(p.wq, p.wk, p.wv)
    q, = _project(x, wq)
    k, v = (_expand_kv(t, q.shape[2]) for t in _project(kv_from, wk, wv))
    q, k, v = _constrain_attn(q, k, v)
    out = _attend_kv(q, k, v, None, softcap, 1.0 / math.sqrt(hd))
    return _out_proj_padded(out, p.wo, real_h)


def _out_proj_padded(out: torch.Tensor, wo: torch.Tensor,
                     real_h: int) -> torch.Tensor:
    """``_out_proj`` of (B, S, H_pad, hd), whose heads from ``real_h`` on
    are padding (``_pad_heads``): ``wo`` gets zero rows for them, so the
    padded heads, exact zeros, add nothing, and heads split over
    ``model`` stay split into the row-parallel product (slicing them off
    would gather every head onto every rank).  A DTensor ``wo`` is padded
    rank by rank (``_head_slice``)."""
    pad = out.shape[2] - real_h
    if pad:
        if sharding._is_dtensor(wo):
            wo = _head_slice(wo, 0, real_h)
        else:
            wo = F.pad(wo, (0, 0, 0, 0, 0, pad))
    return _out_proj(out, wo)


def forward_train(p: AttnParams, x: torch.Tensor, positions: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, use_rope: bool = True,
                  kv_from: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention for training: (B, S, D) -> (B, S, D),
    through the plain ``attend`` (differentiable).  From
    ``CHUNK_THRESHOLD`` tokens the queries go in chunks of ``Q_CHUNK``, so
    logits never exceed (B, H, Q_CHUNK, S).  ``kv_from`` (B, S_enc, D)
    makes it cross-attention (no rope, no mask)."""
    if kv_from is not None:
        return _cross(p, x, kv_from, softcap)
    S = x.shape[1]
    hd = p.wq.shape[2]
    wq, wk, wv, real_h = _pad_heads(p.wq, p.wk, p.wv)
    q, k, v = _project(x, wq, wk, wv)
    if use_rope:
        cos, sin = _rope_tables(positions, hd, q)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
    k = _expand_kv(k, q.shape[2])
    v = _expand_kv(v, q.shape[2])
    q, k, v = _constrain_attn(q, k, v)
    scale = 1.0 / math.sqrt(hd)
    if S < CHUNK_THRESHOLD:
        bias = _mask_bias(positions, positions, causal, window)[None, None]
        out = _attend_kv(q, k, v, bias, softcap, scale)
    else:
        outs = []
        for i0 in range(0, S, Q_CHUNK):
            bias = _mask_bias(positions[i0:i0 + Q_CHUNK], positions, causal,
                              window)[None, None]
            outs.append(_attend_kv(q[:, i0:i0 + Q_CHUNK], k, v, bias,
                                   softcap, scale))
        out = torch.cat(outs, dim=1)
    return _out_proj_padded(out, p.wo, real_h)


def _rope_tables(positions: torch.Tensor, hd: int, like: torch.Tensor):
    """cos/sin of ``positions``, replicated DTensors when ``like`` is one."""
    cos, sin = rope.rope_angles(positions, hd)
    return replicate_like(cos, like), replicate_like(sin, like)


def forward(p: AttnParams, x: torch.Tensor, positions: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None, use_rope: bool = True,
            kv_from: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (prefill): (B, S, D) -> (B, S, D).

    Self-attention sends q/k/v to ``ops.attention`` as (B, H, S, hd) views
    (K/V keep their KV heads: the kernel maps head groups itself); its f32
    result is cast to the working dtype before ``wo``, since the
    reference's ``attend`` returns v's dtype.  With ``kv_from`` (B, S_enc,
    D) it is cross-attention, which the reference computes with the plain
    ``attend`` (no rope, no mask) and so does the port.

    Off the card (the plain version, and the dry run's fake CPU tensors),
    from ``CHUNK_THRESHOLD`` tokens the prefill takes ``forward_train``'s
    q-chunked plain route, the reference's ``forward``: the plain version
    of the kernel would hold (B, H, S, S) logits, where the kernel and the
    reference hold O(S) and (B, H, Q_CHUNK, S).  A CUDA tensor always
    launches the kernel."""
    if kv_from is not None:
        return _cross(p, x, kv_from, softcap)
    if x.shape[1] >= CHUNK_THRESHOLD and x.device.type != "cuda":
        return forward_train(p, x, positions, causal=causal, window=window,
                             softcap=softcap, use_rope=use_rope)
    hd = p.wq.shape[2]
    wq, wk, wv, real_h = _pad_heads(p.wq, p.wk, p.wv)
    q, k, v = _project(x, wq, wk, wv)
    if use_rope:
        # the reference calls rope_angles with its default theta, whatever
        # cfg.rope_theta says; the port does the same
        cos, sin = _rope_tables(positions, hd, q)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
    q, k, v = _constrain_attn(q, k, v)
    out = _flash(q, k, v, causal=causal, window=window, softcap=softcap)
    return _out_proj_padded(out.to(v.dtype), p.wo, real_h)


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, hd)
    v: torch.Tensor       # (B, S_max, KV, hd)


def init_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (batch, s_max, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def prefill(p: AttnParams, x: torch.Tensor, positions: torch.Tensor,
            s_max: int, *, use_rope: bool = True) -> KVCache:
    """Compute and store K/V for the prompt (zero-padded to s_max)."""
    hd = p.wk.shape[2]
    k, v = _project(x, p.wk, p.wv)
    if use_rope:
        cos, sin = _rope_tables(positions, hd, k)
        k = rope.apply_rope(k, cos, sin)
    pad = s_max - k.shape[1]
    if pad > 0:
        k = sharding.pad(k, (0, 0, 0, 0, 0, pad))
        v = sharding.pad(v, (0, 0, 0, 0, 0, pad))
    return KVCache(sharding.constrain_cache(k), sharding.constrain_cache(v))


def cross_decode(p: AttnParams, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Cross-attention during decode: x (B, 1, D) over the static
    (unpadded) encoder KV cache."""
    hd = p.wq.shape[2]
    q, = _project(x, p.wq)
    out = _attend_cache(q, cache.k, cache.v, None, None, 1.0 / math.sqrt(hd))
    return _out_proj(out, p.wo)


def decode_step(p: AttnParams, x: torch.Tensor, cache: KVCache,
                cur_pos: torch.Tensor, *, window: Optional[int] = None,
                softcap: Optional[float] = None, use_rope: bool = True,
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D); ``cur_pos`` a () integer tensor on
    x's device (tokens so far).

    Writes the new K/V into the cache in place (the reference returns an
    updated copy; the cache is the caller's state either way) at slot
    ``cur_pos`` clamped to the last, as the reference's
    ``dynamic_update_slice`` clamps its start, and attends over positions
    [0, cur_pos], optionally windowed.  RoPE and the mask take the
    unclamped ``cur_pos``, as there: past the cache every slot is
    attended to.  The position is never read on the host, so the step
    can be captured into a CUDA graph."""
    hd = p.wq.shape[2]
    S_max = cache.k.shape[1]
    q, k_new, v_new = _project(x, p.wq, p.wk, p.wv)
    pos = cur_pos.reshape(1)
    if use_rope:
        cos, sin = _rope_tables(pos, hd, q)
        q = rope.apply_rope(q, cos, sin)
        k_new = rope.apply_rope(k_new, cos, sin)
    slot = cur_pos.clamp(0, S_max - 1)
    sharding.write_slot(cache.k, k_new.to(cache.k.dtype), 1, slot)
    sharding.write_slot(cache.v, v_new.to(cache.v.dtype), 1, slot)
    k_pos = torch.arange(S_max, device=x.device)
    bias = _mask_bias(pos, k_pos, True, window)[None, None]
    out = _attend_cache(q, cache.k, cache.v, bias, softcap,
                        1.0 / math.sqrt(hd))
    y = _out_proj(out, p.wo)
    return y, cache
