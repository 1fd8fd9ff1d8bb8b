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
whose queries and keys share one length.  The reference's sharding
hooks (``_pad_heads``, ``_constrain_attn``) are no-ops without a mesh and
are left out on one card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ...kernels import ops
from . import rope
from .mlp import normal


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


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, heads, hd) -> (B, S, heads, hd)."""
    return torch.einsum("bsd,dhk->bshk", x, w)


#: sequences at least this long use q-chunked attention (bounded memory)
CHUNK_THRESHOLD = 8192
Q_CHUNK = 1024


def _cross(p: AttnParams, x: torch.Tensor, kv_from: torch.Tensor,
           softcap: Optional[float]) -> torch.Tensor:
    """Cross-attention of x (B, S, D) over ``kv_from`` (B, S_enc, D): no
    rope, no mask, the plain ``attend``."""
    H, hd = p.wq.shape[1], p.wq.shape[2]
    q = _project(x, p.wq)
    k = _expand_kv(_project(kv_from, p.wk), H)
    v = _expand_kv(_project(kv_from, p.wv), H)
    out = attend(q, k, v, None, softcap, 1.0 / math.sqrt(hd))
    return torch.einsum("bqhd,hdk->bqk", out, p.wo)


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
    H, hd = p.wq.shape[1], p.wq.shape[2]
    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if use_rope:
        cos, sin = rope.rope_angles(positions, hd)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = 1.0 / math.sqrt(hd)
    if S < CHUNK_THRESHOLD:
        bias = _mask_bias(positions, positions, causal, window)[None, None]
        out = attend(q, k, v, bias, softcap, scale)
    else:
        outs = []
        for i0 in range(0, S, Q_CHUNK):
            bias = _mask_bias(positions[i0:i0 + Q_CHUNK], positions, causal,
                              window)[None, None]
            outs.append(attend(q[:, i0:i0 + Q_CHUNK], k, v, bias, softcap,
                               scale))
        out = torch.cat(outs, dim=1)
    return torch.einsum("bqhd,hdk->bqk", out, p.wo)


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
    ``attend`` (no rope, no mask) and so does the port."""
    if kv_from is not None:
        return _cross(p, x, kv_from, softcap)
    hd = p.wq.shape[2]
    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if use_rope:
        # the reference calls rope_angles with its default theta, whatever
        # cfg.rope_theta says; the port does the same
        cos, sin = rope.rope_angles(positions, hd)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        softcap=softcap)
    out = out.transpose(1, 2).to(v.dtype)
    return torch.einsum("bqhd,hdk->bqk", out, p.wo)


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
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if use_rope:
        cos, sin = rope.rope_angles(positions, hd)
        k = rope.apply_rope(k, cos, sin)
    pad = s_max - k.shape[1]
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return KVCache(k, v)


def cross_decode(p: AttnParams, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Cross-attention during decode: x (B, 1, D) over the static
    (unpadded) encoder KV cache."""
    H, hd = p.wq.shape[1], p.wq.shape[2]
    q = _project(x, p.wq)
    k = _expand_kv(cache.k, H)
    v = _expand_kv(cache.v, H)
    out = attend(q, k, v, None, None, 1.0 / math.sqrt(hd))
    return torch.einsum("bqhd,hdk->bqk", out, p.wo)


def decode_step(p: AttnParams, x: torch.Tensor, cache: KVCache, cur_pos: int,
                *, window: Optional[int] = None,
                softcap: Optional[float] = None, use_rope: bool = True,
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D); ``cur_pos`` (host int) tokens so far.

    Writes the new K/V into the cache at ``cur_pos`` in place (the
    reference returns an updated copy; the cache is the caller's state
    either way) and attends over positions [0, cur_pos], optionally
    windowed."""
    H, hd = p.wq.shape[1], p.wq.shape[2]
    S_max = cache.k.shape[1]
    if not 0 <= cur_pos < S_max:
        raise ValueError(f"decode position {cur_pos} outside the cache "
                         f"(s_max {S_max})")
    q = _project(x, p.wq)
    k_new = _project(x, p.wk)
    v_new = _project(x, p.wv)
    # a fill kernel: a host-to-device copy here would wait for the stream
    pos = torch.full((1,), cur_pos, device=x.device)
    if use_rope:
        cos, sin = rope.rope_angles(pos, hd)
        q = rope.apply_rope(q, cos, sin)
        k_new = rope.apply_rope(k_new, cos, sin)
    cache.k[:, cur_pos:cur_pos + 1] = k_new.to(cache.k.dtype)
    cache.v[:, cur_pos:cur_pos + 1] = v_new.to(cache.v.dtype)
    k = _expand_kv(cache.k, H)
    v = _expand_kv(cache.v, H)
    k_pos = torch.arange(S_max, device=x.device)
    bias = _mask_bias(pos, k_pos, True, window)[None, None]
    out = attend(q, k, v, bias, softcap, 1.0 / math.sqrt(hd))
    y = torch.einsum("bqhd,hdk->bqk", out, p.wo)
    return y, cache
