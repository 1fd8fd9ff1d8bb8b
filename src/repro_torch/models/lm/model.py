"""Model API of the port: loss, train step (with gradient accumulation),
serve steps, and per-(arch x shape) input specs.

Counterpart of ``repro.models.lm.model``.  PyTorch runs eagerly, so the
steps are plain closures where the reference returns functions to
``jax.jit``; autograd (``torch.autograd.grad``) takes the place of
``jax.value_and_grad``.  ``make_train_step(..., mesh=)`` keeps every
microbatch data-sharded, as the reference's does; the abstract trees
(``abstract_params``, ``abstract_opt_state``, ``init_cache_spec``) are
the reference's ``eval_shape`` trees, as meta tensors or ``TensorSpec``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...configs.base import LMConfig, ShapeSpec
from ...optim import adamw
from ...tree import tree_leaves, tree_map, tree_unflatten
from . import sharding, transformer


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def make_batch_spec(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Stand-ins for every model input."""
    B, S = shape.global_batch, shape.seq_len
    # the reference names this ``f32``; the stub frontends' inputs are bf16
    f32, i32 = torch.bfloat16, torch.int32
    if shape.mode == "train":
        if cfg.is_encdec():
            dec = max(S // cfg.dec_len_ratio, 8)
            return {
                "enc_frames": TensorSpec((B, S, cfg.enc_frame_dim), f32),
                "tokens": TensorSpec((B, dec), i32),
                "labels": TensorSpec((B, dec), i32),
            }
        if cfg.num_prefix_tokens:
            text = S - cfg.num_prefix_tokens
            return {
                "prefix": TensorSpec((B, cfg.num_prefix_tokens, cfg.prefix_dim),
                                     f32),
                "tokens": TensorSpec((B, text), i32),
                "labels": TensorSpec((B, text), i32),
            }
        return {
            "tokens": TensorSpec((B, S), i32),
            "labels": TensorSpec((B, S), i32),
        }
    if shape.mode == "prefill":
        spec = {"tokens": TensorSpec((B, S), i32)}
        if cfg.is_encdec():
            dec = max(S // cfg.dec_len_ratio, 8)
            spec = {
                "enc_frames": TensorSpec((B, S, cfg.enc_frame_dim), f32),
                "tokens": TensorSpec((B, dec), i32),
            }
        elif cfg.num_prefix_tokens:
            spec = {
                "prefix": TensorSpec((B, cfg.num_prefix_tokens, cfg.prefix_dim),
                                     f32),
                "tokens": TensorSpec((B, S - cfg.num_prefix_tokens), i32),
            }
        return spec
    # decode: one new token against an S-long cache
    return {"token": TensorSpec((B, 1), i32)}


def synth_batch(cfg: LMConfig, shape: ShapeSpec, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete random batch matching ``make_batch_spec``, drawn on the
    generator's device and moved to ``device`` (smoke tests)."""
    out = {}
    for name, spec in make_batch_spec(cfg, shape).items():
        if spec.dtype == torch.int32:
            t = torch.randint(0, cfg.vocab, spec.shape, generator=generator,
                              device=generator.device, dtype=torch.int32)
        else:
            t = torch.randn(spec.shape, generator=generator,
                            device=generator.device).to(spec.dtype)
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def loss_fn(cfg: LMConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy (f32).  The image prefix's positions
    are dropped before the head."""
    hidden = transformer.forward_train(
        cfg, params, batch["tokens"], enc_frames=batch.get("enc_frames"),
        prefix=batch.get("prefix"))
    if batch.get("prefix") is not None:
        hidden = hidden[:, batch["prefix"].shape[1]:, :]
    logits = transformer.logits_head(cfg, params, hidden)
    # shift: predict t+1 from t
    logits = logits[:, :-1]
    targets = batch["labels"][:, 1:]
    logz = sharding.logsumexp(logits)
    gold = sharding.take_last(logits, targets)
    return torch.mean(logz - gold)


def loss_and_grads(cfg: LMConfig, params, batch: Dict[str, torch.Tensor]):
    """(loss, gradient tree) of ``loss_fn`` at ``params``, the port's
    ``jax.value_and_grad``: gradients have the parameters' dtypes, and the
    parameters themselves are left as they were."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# train step (microbatched gradient accumulation)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainStepConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()


def make_train_step(cfg: LMConfig, tcfg: Optional[TrainStepConfig] = None,
                    microbatch: Optional[int] = None, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    The global batch is split into ``min(microbatch or cfg.microbatch, B)``
    row slices run one after another, with f32 gradient accumulation
    (memory bounded by the microbatch, not the global batch); the summed
    gradients and losses are divided by the number of slices.  With a
    ``mesh`` (a ``DeviceMesh``; parameters, state and batch placed on it as
    DTensors) each slice takes its rows from every rank's own batch shard
    (``sharding.microbatch_rows``: no rank gathers the batch) and is
    redistributed with its batch over the data axes, replicated where the
    slice does not divide them.
    """
    tcfg = tcfg or TrainStepConfig()

    def constrain_batch(b):
        if mesh is None:
            return b
        dp = sharding.dp_axes(mesh)

        def rule(x):
            spec = [dp] + [None] * (x.ndim - 1)
            if x.shape[0] % sharding._axis_size(mesh, dp) != 0:
                spec[0] = None
            return sharding.to_spec(x, spec)
        return {k: rule(v) for k, v in b.items()}

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        mb = min(microbatch or cfg.microbatch, B)
        n_mb = max(B // mb, 1)
        if n_mb == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
        else:
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n_mb):
                mb_batch = constrain_batch(
                    {k: sharding.microbatch_rows(v, i, mb)
                     for k, v in batch.items()})
                loss, grads = loss_and_grads(cfg, params, mb_batch)
                for a, g in zip(tree_leaves(gsum), tree_leaves(grads)):
                    a.add_(g)          # in f32: a + f32(g), as the reference
                del grads
                lsum = lsum + loss
            grads = tree_map(lambda g: adamw.true_div(g, n_mb), gsum)
            loss = adamw.true_div(lsum, n_mb)
        new_params, new_opt, metrics = adamw.apply(tcfg.opt, params, opt_state,
                                                   grads)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: LMConfig, s_max: int):
    def prefill_step(params, batch):
        return transformer.prefill(cfg, params, batch["tokens"], s_max,
                                   enc_frames=batch.get("enc_frames"),
                                   prefix=batch.get("prefix"))
    return prefill_step


def make_decode_step(cfg: LMConfig):
    def decode_step(params, token, cache):
        return transformer.decode(cfg, params, token, cache)
    return decode_step


# ---------------------------------------------------------------------------
# abstract trees (dry run)
# ---------------------------------------------------------------------------

def init_cache_spec(cfg: LMConfig, shape: ShapeSpec) -> transformer.ServeCache:
    """The ``ServeCache`` a prefill of ``shape.seq_len`` tokens would
    produce, as ``TensorSpec``s (the reference's abstract cache, entry for
    entry; ``cur_pos`` a () int32 spec, as a prefill's cache holds a ()
    int32 tensor)."""
    B, S = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16

    def attn_entry(n):
        kv = TensorSpec((n, B, S, cfg.n_kv_heads, cfg.hd), bf16)
        return transformer.attention.KVCache(kv, kv)

    def ssm_entry(n):
        return transformer.ssm.SSMState(
            conv=TensorSpec((n, B, cfg.conv_k - 1, cfg.d_inner), bf16),
            h=TensorSpec((n, B, cfg.d_inner, cfg.ssm_state), torch.float32))

    def rec_entry(n):
        return transformer.rglru.RGLRUState(
            conv=TensorSpec((n, B, cfg.conv_k - 1, cfg.d_inner), bf16),
            h=TensorSpec((n, B, cfg.d_inner), torch.float32))

    entries = []
    for seg in cfg.segments:
        if seg.kind == "attn":
            entries.append(attn_entry(seg.n))
        elif seg.kind == "ssm":
            entries.append(ssm_entry(seg.n))
        elif seg.kind == "rec":
            entries.append(rec_entry(seg.n))
        elif seg.kind == "hybrid3":
            entries.append((rec_entry(seg.n), rec_entry(seg.n),
                            attn_entry(seg.n)))
        elif seg.kind == "xattn":
            entries.append((attn_entry(seg.n), attn_entry(seg.n)))
        else:
            raise ValueError(seg.kind)
    return transformer.ServeCache(tuple(entries), TensorSpec((), torch.int32))


def abstract_params(cfg: LMConfig):
    """Parameter shapes and dtypes without allocation: meta tensors."""
    return transformer.init_params(cfg, torch.Generator(), device="meta")


def abstract_opt_state(cfg: LMConfig) -> adamw.AdamWState:
    """Optimizer-state shapes and dtypes without allocation (meta)."""
    return adamw.init(abstract_params(cfg))
