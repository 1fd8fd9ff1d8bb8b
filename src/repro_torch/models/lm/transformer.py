"""Transformer, SSM and hybrid stacks for the assigned archs, for training
and serving.

Counterpart of ``repro.models.lm.transformer``.  Parameters keep the
reference's tree: ``embed`` (V, D), ``final_norm``, and ``segments``, one
entry per config segment whose leaves carry a leading layer axis
(L, ...), as ``jax.vmap(init_block)`` makes them; an encoder-decoder
(whisper) adds ``enc_segments`` and ``enc_final_norm``.  Where the
reference runs ``lax.scan`` over that axis, the port runs a Python loop
over views of each layer's slice.  Block kinds: ``attn`` (attention +
FFN, the FFN a capacity-routed MoE when ``cfg.n_experts``), ``ssm``
(mamba), ``rec`` (RG-LRU + FFN), ``hybrid3`` (rec, rec, local attention:
recurrentgemma) and ``xattn`` (self + cross attention: whisper's
decoder).  Three modes:

* ``forward_train`` — full sequence through the differentiable plain
  attention (``attention.forward_train``), each layer wrapped in
  ``torch.utils.checkpoint`` when ``cfg.remat`` (the counterpart of
  ``jax.checkpoint``); returns the final hidden states for the loss head.
  The layers are views of the stacked leaves (``torch.unbind``), so
  autograd gathers the layers' gradients into one (L, ...) gradient per
  leaf.
* ``prefill`` — full sequence, self-attention through the flash kernel
  (the whisper encoder's non-causal too); returns the last position's
  logits and per-segment caches stacked (L, ...): a ``KVCache`` for
  ``attn``, an ``SSMState`` or ``RGLRUState`` for ``ssm``/``rec``, a
  (rec1, rec2, kv) triple for ``hybrid3`` and a (self, cross) pair of
  ``KVCache`` for ``xattn``.
* ``decode``  — one token against those caches, updated in place.

Whisper's encoder takes stub frame embeddings (B, S_enc, D) and
PaliGemma prepends stub image-patch embeddings (B, P, D) to the token
embeddings; ``ServeCache.cur_pos`` counts the prefix, as in the
reference.  The reference's sharding hook ``constrain_tokens`` opens every
block, as there (a no-op without an ``activation_mesh``), and the port
also applies it after each residual add inside a block and before each
final norm, so that a partial sum over the model axis is reduced there
and not split along the sequence by DTensor; a sinusoid
table meeting DTensor embeddings becomes a replicated DTensor.  As in
the reference,
RMSNorm multiplies by ``scale`` and the embedding is not scaled by
sqrt(D).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ...configs.base import LMConfig, Segment
from ...tree import tree_leaves, tree_map, tree_unflatten
from . import attention, mlp, moe, rglru, sharding, ssm
from .sharding import constrain_tokens, replicate_like


# ---------------------------------------------------------------------------
# norms (config-selected)
# ---------------------------------------------------------------------------

def norm_init(cfg: LMConfig, device="cuda"):
    if cfg.norm_kind == "ln":
        return mlp.layernorm_init(cfg.d_model, device=device)
    return mlp.rmsnorm_init(cfg.d_model, device=device)


def norm_apply(cfg: LMConfig, p, x):
    if cfg.norm_kind == "ln":
        return mlp.layernorm(p, x)
    return mlp.rmsnorm(p, x)


# ---------------------------------------------------------------------------
# per-layer block params
# ---------------------------------------------------------------------------

def _ffn_init(cfg: LMConfig, generator: torch.Generator, device):
    if cfg.n_experts:
        return moe.init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                        device=device)
    if cfg.mlp_kind == "plain":
        return mlp.init_plain(generator, cfg.d_model, cfg.d_ff, device=device)
    return mlp.init_gated(generator, cfg.d_model, cfg.d_ff, device=device)


def _ffn_apply(cfg: LMConfig, p, x):
    if cfg.n_experts:
        return moe.forward(p, x, cfg.top_k, cfg.capacity_factor, cfg.act)
    if cfg.mlp_kind == "plain":
        return mlp.plain(p, x, cfg.act)
    return mlp.gated(p, x, cfg.act)


def _attn_init(cfg: LMConfig, generator: torch.Generator, device):
    return attention.init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, device=device)


def init_block(cfg: LMConfig, kind: str, generator: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    if kind == "attn":
        return {
            "norm1": norm_init(cfg, device),
            "attn": _attn_init(cfg, generator, device),
            "norm2": norm_init(cfg, device),
            "ffn": _ffn_init(cfg, generator, device),
        }
    if kind == "ssm":
        return {
            "norm": norm_init(cfg, device),
            "ssm": ssm.init(generator, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                            cfg.dt_rank, cfg.conv_k, device=device),
        }
    if kind == "rec":
        return {
            "norm1": norm_init(cfg, device),
            "rec": rglru.init(generator, cfg.d_model, cfg.d_inner, cfg.conv_k,
                              device=device),
            "norm2": norm_init(cfg, device),
            "ffn": _ffn_init(cfg, generator, device),
        }
    if kind == "hybrid3":
        return {
            "rec1": init_block(cfg, "rec", generator, device),
            "rec2": init_block(cfg, "rec", generator, device),
            "attn": init_block(cfg, "attn", generator, device),
        }
    if kind == "xattn":
        return {
            "norm1": norm_init(cfg, device),
            "self": _attn_init(cfg, generator, device),
            "norm2": norm_init(cfg, device),
            "cross": _attn_init(cfg, generator, device),
            "norm3": norm_init(cfg, device),
            "ffn": _ffn_init(cfg, generator, device),
        }
    raise ValueError(f"unknown block kind {kind}")


def _stack(trees: list):
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    return tree_map(lambda *xs: sharding.stack(xs), *trees)


def init_segment(cfg: LMConfig, seg: Segment, generator: torch.Generator,
                 device="cuda"):
    """``seg.n`` blocks stacked leaf by leaf on a leading layer axis."""
    return _stack([init_block(cfg, seg.kind, generator, device)
                   for _ in range(seg.n)])


def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random bf16 parameters drawn from ``generator`` on its own device
    and moved to ``device`` (one CPU seed gives the same weights on every
    device).  ``device="meta"`` gives shapes only."""
    params: Dict[str, Any] = {
        "embed": mlp.normal(generator, (cfg.vocab, cfg.d_model),
                            1.0 / math.sqrt(cfg.d_model), device=device),
        "final_norm": norm_init(cfg, device),
        "segments": [init_segment(cfg, seg, generator, device)
                     for seg in cfg.segments],
    }
    if cfg.enc_segments:
        params["enc_segments"] = [init_segment(cfg, seg, generator, device)
                                  for seg in cfg.enc_segments]
        params["enc_final_norm"] = norm_init(cfg, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = mlp.normal(generator, (cfg.d_model, cfg.vocab),
                                       1.0 / math.sqrt(cfg.d_model), device=device)
    return params


def param_count(cfg: LMConfig) -> int:
    params = init_params(cfg, torch.Generator(), device="meta")
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------

def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(cfg: LMConfig, params, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) token ids -> (B, S, D) rows of ``embed`` (unscaled), plus the
    sinusoid of ``positions`` (S,) where the config uses one."""
    x = sharding.lookup_rows(params["embed"], tokens)
    if cfg.pos_embed == "sinusoid":
        x = x + replicate_like(_sinusoid(positions, cfg.d_model).to(x.dtype),
                               x)
    return x


def logits_head(cfg: LMConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = sharding.matmul(x, w).to(torch.float32)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# full-sequence block application (train / prefill)
# ---------------------------------------------------------------------------

def _attn_block_fwd(cfg, p, x, positions, window, causal=True,
                    want_cache=False, s_max=0, attn_fwd=attention.forward):
    """One attention block.  ``attn_fwd`` is ``attention.forward`` (the
    flash kernel, serving) or ``attention.forward_train`` (training)."""
    x = constrain_tokens(x)
    h = norm_apply(cfg, p["norm1"], x)
    a = attn_fwd(p["attn"], h, positions, causal=causal, window=window,
                 softcap=cfg.attn_softcap, use_rope=(cfg.pos_embed == "rope"))
    cache = None
    if want_cache:
        # K/V of this layer come from the same normed input the attention
        # consumed; as in the reference they are projected a second time
        cache = attention.prefill(p["attn"], h, positions, s_max,
                                  use_rope=(cfg.pos_embed == "rope"))
    x = constrain_tokens(x + a)
    h = norm_apply(cfg, p["norm2"], x)
    x = x + _ffn_apply(cfg, p["ffn"], h)
    return x, cache


def _ssm_block_fwd(cfg, p, x, state=None):
    x = constrain_tokens(x)
    h = norm_apply(cfg, p["norm"], x)
    y, new_state = ssm.forward(p["ssm"], h, state)
    return x + y, new_state


def _rec_block_fwd(cfg, p, x, state=None):
    x = constrain_tokens(x)
    h = norm_apply(cfg, p["norm1"], x)
    y, new_state = rglru.forward(p["rec"], h, state)
    x = constrain_tokens(x + y)
    h = norm_apply(cfg, p["norm2"], x)
    x = x + _ffn_apply(cfg, p["ffn"], h)
    return x, new_state


def _xattn_block_fwd(cfg, p, x, positions, enc_out, want_cache=False,
                     s_max=0, attn_fwd=attention.forward):
    x = constrain_tokens(x)
    h = norm_apply(cfg, p["norm1"], x)
    a = attn_fwd(p["self"], h, positions, causal=True,
                 use_rope=(cfg.pos_embed == "rope"))
    self_cache = None
    if want_cache:
        self_cache = attention.prefill(p["self"], h, positions, s_max,
                                       use_rope=(cfg.pos_embed == "rope"))
    x = constrain_tokens(x + a)
    h = norm_apply(cfg, p["norm2"], x)
    c = attn_fwd(p["cross"], h, positions, kv_from=enc_out)
    cross_cache = None
    if want_cache:
        S_enc = enc_out.shape[1]
        cross_cache = attention.prefill(
            p["cross"], enc_out, torch.arange(S_enc, device=enc_out.device),
            S_enc, use_rope=False)
    x = constrain_tokens(x + c)
    h = norm_apply(cfg, p["norm3"], x)
    x = x + _ffn_apply(cfg, p["ffn"], h)
    if want_cache:
        return x, (self_cache, cross_cache)
    return x, None


def layer(seg_params, i: int):
    """Views of layer ``i`` of a segment's stacked parameters (or caches)."""
    return tree_map(lambda t: t[i], seg_params)


def layers(seg_params) -> list:
    """Views of every layer of a segment's stacked parameters, by one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where L separate ``t[i]`` would each add a full (L, ...) buffer."""
    per_leaf = [t.unbind(0) for t in tree_leaves(seg_params)]
    return [tree_unflatten(seg_params, views) for views in zip(*per_leaf)]


def _maybe_remat(cfg: LMConfig, fn):
    if not cfg.remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def run_segment_train(cfg: LMConfig, seg: Segment, seg_params, x, positions,
                      enc_out=None, causal=True):
    """The segment's layers over x (B, S, D), differentiably."""
    train = attention.forward_train

    if seg.kind == "attn":
        def body(h, p_l, w):
            return _attn_block_fwd(cfg, p_l, h, positions, w, causal=causal,
                                   attn_fwd=train)[0]
    elif seg.kind == "ssm":
        def body(h, p_l, w):
            return _ssm_block_fwd(cfg, p_l, h)[0]
    elif seg.kind == "rec":
        def body(h, p_l, w):
            return _rec_block_fwd(cfg, p_l, h)[0]
    elif seg.kind == "hybrid3":
        def body(h, p_l, w):
            h, _ = _rec_block_fwd(cfg, p_l["rec1"], h)
            h, _ = _rec_block_fwd(cfg, p_l["rec2"], h)
            return _attn_block_fwd(cfg, p_l["attn"], h, positions, w,
                                   attn_fwd=train)[0]
    elif seg.kind == "xattn":
        def body(h, p_l, w):
            return _xattn_block_fwd(cfg, p_l, h, positions, enc_out,
                                    attn_fwd=train)[0]
    else:
        raise ValueError(seg.kind)

    body = _maybe_remat(cfg, body)
    for p_l, w in zip(layers(seg_params), seg.windows(), strict=True):
        x = body(x, p_l, w)
    return x


def encode(cfg: LMConfig, params, frames: torch.Tensor,
           train: bool = True) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, S_enc, D), non-causal:
    differentiably (``train``) or through the flash kernel (prefill)."""
    S = frames.shape[1]
    positions = torch.arange(S, device=frames.device)
    x = frames.to(torch.bfloat16)
    if cfg.pos_embed == "sinusoid":
        x = x + replicate_like(_sinusoid(positions, cfg.d_model).to(x.dtype),
                               x)
    for seg, seg_params in zip(cfg.enc_segments, params["enc_segments"]):
        if train:
            x = run_segment_train(cfg, seg, seg_params, x, positions,
                                  causal=False)
            continue
        if seg.kind != "attn":
            raise ValueError(f"encoder segment kind {seg.kind}")
        for p_l, w in zip(layers(seg_params), seg.windows(), strict=True):
            x, _ = _attn_block_fwd(cfg, p_l, x, positions, w, causal=False)
    return norm_apply(cfg, params["enc_final_norm"], constrain_tokens(x))


def _embed_inputs(cfg: LMConfig, params, tokens: torch.Tensor,
                  prefix: Optional[torch.Tensor]):
    """(x, positions) of the decoder's input: the token embeddings, after
    the image prefix (B, P, D) where there is one."""
    S = tokens.shape[1]
    dev = tokens.device
    if prefix is None:
        positions = torch.arange(S, device=dev)
        return embed_tokens(cfg, params, tokens, positions), positions
    P = prefix.shape[1]
    positions = torch.arange(P + S, device=dev)
    x_tok = embed_tokens(cfg, params, tokens, positions[P:])
    return torch.cat([prefix.to(x_tok.dtype), x_tok], dim=1), positions


def forward_train(cfg: LMConfig, params, tokens: torch.Tensor,
                  enc_frames: Optional[torch.Tensor] = None,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns the final hidden states (B, S_total, D) of tokens (B, S)."""
    enc_out = encode(cfg, params, enc_frames) if cfg.is_encdec() else None
    x, positions = _embed_inputs(cfg, params, tokens, prefix)
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        x = run_segment_train(cfg, seg, seg_params, x, positions,
                              enc_out=enc_out)
    return norm_apply(cfg, params["final_norm"], constrain_tokens(x))


# ---------------------------------------------------------------------------
# serving: prefill + decode against stacked caches
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    """Per-segment stacked caches, one entry per config segment."""
    entries: Tuple[Any, ...]
    cur_pos: torch.Tensor          # () int32 - tokens so far, prefix included


def _prefill_segment(cfg: LMConfig, seg: Segment, seg_params, x, positions,
                     s_max: int, enc_out):
    """The segment's layers over x through the serving routes; returns x
    and the segment's caches stacked (L, ...)."""
    caches = []
    for p_l, w in zip(layers(seg_params), seg.windows(), strict=True):
        if seg.kind == "attn":
            x = constrain_tokens(x)
            x, c = _attn_block_fwd(cfg, p_l, x, positions, w, want_cache=True,
                                   s_max=s_max)
        elif seg.kind == "ssm":
            x = constrain_tokens(x)
            x, c = _ssm_block_fwd(cfg, p_l, x)
        elif seg.kind == "rec":
            x, c = _rec_block_fwd(cfg, p_l, x)
        elif seg.kind == "hybrid3":
            x, st1 = _rec_block_fwd(cfg, p_l["rec1"], x)
            x, st2 = _rec_block_fwd(cfg, p_l["rec2"], x)
            x, kv = _attn_block_fwd(cfg, p_l["attn"], x, positions, w,
                                    want_cache=True, s_max=s_max)
            c = (st1, st2, kv)
        elif seg.kind == "xattn":
            x, c = _xattn_block_fwd(cfg, p_l, x, positions, enc_out,
                                    want_cache=True, s_max=s_max)
        else:
            raise ValueError(seg.kind)
        caches.append(c)
    return x, _stack(caches)


def prefill(cfg: LMConfig, params, tokens: torch.Tensor, s_max: int,
            enc_frames: Optional[torch.Tensor] = None,
            prefix: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, ServeCache]:
    """Process the prompt (B, S) (after the image prefix, where given);
    returns (last-position logits (B, 1, V), caches)."""
    total = tokens.shape[1] + (prefix.shape[1] if prefix is not None else 0)
    if total > s_max:
        raise ValueError(f"prompt of {total} positions exceeds s_max {s_max}")
    enc_out = encode(cfg, params, enc_frames, train=False) \
        if cfg.is_encdec() else None
    x, positions = _embed_inputs(cfg, params, tokens, prefix)
    entries = []
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        x, caches = _prefill_segment(cfg, seg, seg_params, x, positions, s_max,
                                     enc_out)
        entries.append(caches)
    x = norm_apply(cfg, params["final_norm"], constrain_tokens(x))
    logits = logits_head(cfg, params, x[:, -1:, :])
    # a fill kernel: a host-to-device copy here would wait for the stream
    cur_pos = torch.full((), total, dtype=torch.int32, device=tokens.device)
    return logits, ServeCache(tuple(entries), cur_pos)


def _write(view, new) -> None:
    """Copy a layer's new state into its slice of the stacked cache."""
    for dst, src in zip(tree_leaves(view), tree_leaves(new), strict=True):
        dst.copy_(src)


def _attn_decode(cfg, p, x, kv, cur, window):
    x = constrain_tokens(x)
    h = norm_apply(cfg, p["norm1"], x)
    a, _ = attention.decode_step(p["attn"], h, kv, cur, window=window,
                                 softcap=cfg.attn_softcap,
                                 use_rope=(cfg.pos_embed == "rope"))
    x = constrain_tokens(x + a)
    h = norm_apply(cfg, p["norm2"], x)
    return x + _ffn_apply(cfg, p["ffn"], h)


def _rec_decode(cfg, p, x, st):
    x, new = _rec_block_fwd(cfg, p, x, st)
    _write(st, new)
    return x


def decode(cfg: LMConfig, params, token: torch.Tensor, cache: ServeCache
           ) -> Tuple[torch.Tensor, ServeCache]:
    """One decode step.  token (B, 1) -> (logits (B, 1, V), cache).  The
    caches (KV and recurrent states) and the position ``cur_pos`` are
    updated in place (the position by ``add_(1)`` at the end); the
    returned cache shares them.  The position is a () int32 tensor, never
    read on the host, so that the step can be captured into a CUDA graph
    (``runtime.serve_loop``); a Python int is taken as ``jax.jit`` takes
    one for the reference's () int32 argument, and made a tensor."""
    cur_pos = cache.cur_pos
    if not isinstance(cur_pos, torch.Tensor):
        cur_pos = torch.tensor(cur_pos, dtype=torch.int32, device=token.device)
    # a replicated DTensor under a mesh: every rank holds the whole value
    cur = cur_pos.to_local() if sharding._is_dtensor(cur_pos) else cur_pos
    pos = cur.reshape(1) if cfg.pos_embed == "sinusoid" else None
    x = embed_tokens(cfg, params, token, pos)
    for seg, seg_params, entry in zip(cfg.segments, params["segments"],
                                      cache.entries):
        for i, w in enumerate(seg.windows()):
            p_l, c = layer(seg_params, i), layer(entry, i)
            if seg.kind == "attn":
                x = _attn_decode(cfg, p_l, x, c, cur, w)
            elif seg.kind == "ssm":
                x, new = _ssm_block_fwd(cfg, p_l, x, c)
                _write(c, new)
            elif seg.kind == "rec":
                x = _rec_decode(cfg, p_l, x, c)
            elif seg.kind == "hybrid3":
                st1, st2, kv = c
                x = _rec_decode(cfg, p_l["rec1"], x, st1)
                x = _rec_decode(cfg, p_l["rec2"], x, st2)
                x = _attn_decode(cfg, p_l["attn"], x, kv, cur, w)
            elif seg.kind == "xattn":
                kv_self, kv_cross = c
                x = constrain_tokens(x)
                h = norm_apply(cfg, p_l["norm1"], x)
                a, _ = attention.decode_step(p_l["self"], h, kv_self, cur,
                                             use_rope=(cfg.pos_embed == "rope"))
                x = constrain_tokens(x + a)
                h = norm_apply(cfg, p_l["norm2"], x)
                x = constrain_tokens(
                    x + attention.cross_decode(p_l["cross"], h, kv_cross))
                h = norm_apply(cfg, p_l["norm3"], x)
                x = x + _ffn_apply(cfg, p_l["ffn"], h)
            else:
                raise ValueError(seg.kind)
    x = norm_apply(cfg, params["final_norm"], constrain_tokens(x))
    logits = logits_head(cfg, params, x)
    cur_pos.add_(1)
    return logits, ServeCache(cache.entries, cur_pos)
