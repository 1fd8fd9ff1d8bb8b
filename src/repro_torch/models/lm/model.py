"""Model API of the port: loss, train step (with gradient accumulation),
serve steps, and per-(arch x shape) input specs.

Counterpart of ``repro.models.lm.model``.  PyTorch runs eagerly, so the
steps are plain closures where the reference returns functions to
``jax.jit``; autograd (``torch.autograd.grad``) takes the place of
``jax.value_and_grad``.  The reference's ``mesh`` hooks are no-ops on one
card and are left out, as in the serving slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...configs.base import LMConfig, ShapeSpec
from ...optim import adamw
from ...tree import tree_leaves, tree_map, tree_unflatten
from . import transformer


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
    """Mean next-token cross-entropy (f32)."""
    hidden = transformer.forward_train(cfg, params, batch["tokens"])
    logits = transformer.logits_head(cfg, params, hidden)
    # shift: predict t+1 from t
    logits = logits[:, :-1]
    targets = batch["labels"][:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
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
                    microbatch: Optional[int] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    The global batch is split into ``min(microbatch or cfg.microbatch, B)``
    row slices run one after another, with f32 gradient accumulation
    (memory bounded by the microbatch, not the global batch); the summed
    gradients and losses are divided by the number of slices.
    """
    tcfg = tcfg or TrainStepConfig()

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        mb = min(microbatch or cfg.microbatch, B)
        n_mb = max(B // mb, 1)
        if n_mb == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n_mb):
                mb_batch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
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
        return transformer.prefill(cfg, params, batch["tokens"], s_max)
    return prefill_step


def make_decode_step(cfg: LMConfig):
    def decode_step(params, token, cache):
        return transformer.decode(cfg, params, token, cache)
    return decode_step
