"""Dense attention-only transformer stacks for training and serving.

Counterpart of ``repro.models.lm.transformer`` for ``attn`` segments.
Parameters keep the reference's tree: ``embed`` (V, D), ``final_norm``,
and ``segments``, one entry per config segment whose leaves carry a
leading layer axis (L, ...), as ``jax.vmap(init_block)`` makes them.
Where the reference runs ``lax.scan`` over that axis, the port runs a
Python loop over views of each layer's slice.  Three modes:

* ``forward_train`` — full sequence through the differentiable plain
  attention (``attention.forward_train``), each layer wrapped in
  ``torch.utils.checkpoint`` when ``cfg.remat`` (the counterpart of
  ``jax.checkpoint``); returns the final hidden states for the loss head.
  The layers are views of the stacked leaves (``torch.unbind``), so
  autograd gathers the layers' gradients into one (L, ...) gradient per
  leaf.
* ``prefill`` — full sequence through the flash kernel; returns the last
  position's logits and the per-segment KV caches stacked
  (L, B, S_max, KV, hd).
* ``decode``  — one token against those caches, updated in place.

Other segment kinds (ssm, rec, hybrid3, xattn), MoE FFNs, encoders, image
prefixes and sinusoidal positions raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them.  The reference's sharding hook
``constrain_tokens`` is a no-op without a mesh and is left out on one
card.  As in the reference, RMSNorm multiplies by ``scale`` and the
embedding is not scaled by sqrt(D).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ...configs.base import LMConfig, Segment
from ...tree import tree_leaves, tree_map, tree_unflatten
from . import attention, mlp

_LATER = "see ROADMAP.md §1, 'Other LM families'"


def _check_supported(cfg: LMConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported yet; {_LATER}")
    kinds = {s.kind for s in cfg.segments}
    if kinds != {"attn"} or cfg.enc_segments:
        raise NotImplementedError(
            f"{cfg.name}: segment kinds {sorted(kinds)} (and encoders) are not "
            f"ported yet, only 'attn'; {_LATER}")
    if cfg.num_prefix_tokens or cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"{cfg.name}: image prefixes and non-rope positions are not "
            f"ported yet; {_LATER}")


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
    if cfg.mlp_kind == "plain":
        return mlp.init_plain(generator, cfg.d_model, cfg.d_ff, device=device)
    return mlp.init_gated(generator, cfg.d_model, cfg.d_ff, device=device)


def _ffn_apply(cfg: LMConfig, p, x):
    if cfg.mlp_kind == "plain":
        return mlp.plain(p, x, cfg.act)
    return mlp.gated(p, x, cfg.act)


def init_block(cfg: LMConfig, kind: str, generator: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    if kind != "attn":
        raise NotImplementedError(f"block kind '{kind}' is not ported yet; {_LATER}")
    return {
        "norm1": norm_init(cfg, device),
        "attn": attention.init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, device=device),
        "norm2": norm_init(cfg, device),
        "ffn": _ffn_init(cfg, generator, device),
    }


def init_segment(cfg: LMConfig, seg: Segment, generator: torch.Generator,
                 device="cuda"):
    """``seg.n`` blocks stacked leaf by leaf on a leading layer axis."""
    blocks = [init_block(cfg, seg.kind, generator, device) for _ in range(seg.n)]
    leaves = [tree_leaves(b) for b in blocks]
    return tree_unflatten(blocks[0], [torch.stack([lv[i] for lv in leaves])
                                      for i in range(len(leaves[0]))])


def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random bf16 parameters drawn from ``generator`` on its own device
    and moved to ``device`` (one CPU seed gives the same weights on every
    device).  ``device="meta"`` gives shapes only."""
    _check_supported(cfg)
    params: Dict[str, Any] = {
        "embed": mlp.normal(generator, (cfg.vocab, cfg.d_model),
                            1.0 / math.sqrt(cfg.d_model), device=device),
        "final_norm": norm_init(cfg, device),
        "segments": [init_segment(cfg, seg, generator, device)
                     for seg in cfg.segments],
    }
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

def embed_tokens(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) token ids -> (B, S, D) rows of ``embed`` (unscaled)."""
    return params["embed"][tokens]


def logits_head(cfg: LMConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w).to(torch.float32)
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
    h = norm_apply(cfg, p["norm1"], x)
    a = attn_fwd(p["attn"], h, positions, causal=causal, window=window,
                 softcap=cfg.attn_softcap, use_rope=(cfg.pos_embed == "rope"))
    cache = None
    if want_cache:
        # K/V of this layer come from the same normed input the attention
        # consumed; as in the reference they are projected a second time
        cache = attention.prefill(p["attn"], h, positions, s_max,
                                  use_rope=(cfg.pos_embed == "rope"))
    x = x + a
    h = norm_apply(cfg, p["norm2"], x)
    x = x + _ffn_apply(cfg, p["ffn"], h)
    return x, cache


def layer(seg_params, i: int):
    """Views of layer ``i`` of a segment's stacked parameters."""
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
                      causal=True):
    """The segment's layers over x (B, S, D), differentiably."""
    if seg.kind != "attn":
        raise NotImplementedError(f"block kind '{seg.kind}' is not ported yet; "
                                  f"{_LATER}")

    def body(h, p_l, w):
        return _attn_block_fwd(cfg, p_l, h, positions, w, causal=causal,
                               attn_fwd=attention.forward_train)[0]

    body = _maybe_remat(cfg, body)
    for p_l, w in zip(layers(seg_params), seg.windows(), strict=True):
        x = body(x, p_l, w)
    return x


def forward_train(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Returns the final hidden states (B, S, D) of tokens (B, S)."""
    _check_supported(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        x = run_segment_train(cfg, seg, seg_params, x, positions)
    return norm_apply(cfg, params["final_norm"], x)


# ---------------------------------------------------------------------------
# serving: prefill + decode against stacked caches
# ---------------------------------------------------------------------------

class ServeCache(NamedTuple):
    """Per-segment stacked caches, one entry per config segment."""
    entries: Tuple[Any, ...]
    cur_pos: int                   # tokens decoded so far (host int)


def prefill(cfg: LMConfig, params, tokens: torch.Tensor, s_max: int
            ) -> Tuple[torch.Tensor, ServeCache]:
    """Process the prompt (B, S); returns (last-position logits (B, 1, V),
    caches)."""
    _check_supported(cfg)
    S = tokens.shape[1]
    if S > s_max:
        raise ValueError(f"prompt of {S} tokens exceeds s_max {s_max}")
    positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    entries = []
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        ks, vs = [], []
        for i, w in enumerate(seg.windows()):
            x, kv = _attn_block_fwd(cfg, layer(seg_params, i), x, positions,
                                    w, want_cache=True, s_max=s_max)
            ks.append(kv.k)
            vs.append(kv.v)
        entries.append(attention.KVCache(torch.stack(ks), torch.stack(vs)))
    x = norm_apply(cfg, params["final_norm"], x)
    logits = logits_head(cfg, params, x[:, -1:, :])
    return logits, ServeCache(tuple(entries), S)


def decode(cfg: LMConfig, params, token: torch.Tensor, cache: ServeCache
           ) -> Tuple[torch.Tensor, ServeCache]:
    """One decode step.  token (B, 1) -> (logits (B, 1, V), cache).  The
    caches are updated in place; the returned cache shares them."""
    _check_supported(cfg)
    cur = cache.cur_pos
    x = embed_tokens(cfg, params, token)
    for seg, seg_params, entry in zip(cfg.segments, params["segments"],
                                      cache.entries):
        for i, w in enumerate(seg.windows()):
            p_l = layer(seg_params, i)
            h = norm_apply(cfg, p_l["norm1"], x)
            a, _ = attention.decode_step(
                p_l["attn"], h, attention.KVCache(entry.k[i], entry.v[i]),
                cur, window=w, softcap=cfg.attn_softcap,
                use_rope=(cfg.pos_embed == "rope"))
            x = x + a
            h = norm_apply(cfg, p_l["norm2"], x)
            x = x + _ffn_apply(cfg, p_l["ffn"], h)
    x = norm_apply(cfg, params["final_norm"], x)
    logits = logits_head(cfg, params, x)
    return logits, ServeCache(cache.entries, cur + 1)
