"""AdamW + cosine schedule on trees of tensors.

Counterpart of ``repro.optim.adamw``, in its order of operations: the
clip scale from the global norm, then the bias corrections ``b ** step``
in f32, then ``mhat / (sqrt(vhat) + eps) + wd * p``, then one cast back to
the parameter's dtype.  m and v are f32 whatever the parameter dtype
(bf16 parameters, f32 moments); ``step`` is a 0-d int32 tensor.  The
update is functional, as in the reference: ``apply`` returns new
parameters and state and leaves its inputs as they were.  The step count,
the schedule and the clip scale stay on the device, so a CUDA graph can
capture the update.  On the card the training loop captures it with a
commit of the new values over the old (``runtime.train_loop``
``GraphedTrainStep``): that step is not functional, and the loop rolls
back from its checkpoints, never to a half-updated state.

Every division by a Python number divides by a tensor (``true_div``):
PyTorch's CUDA division by a Python number multiplies by its float32
reciprocal, which can differ from the quotient in the last bit.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: Any                      # tree like params (f32)
    v: Any                      # tree like params (f32)


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE quotient in float32 on every device."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def init(params) -> AdamWState:
    """Zero moments on the parameters' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (f32, on step's
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(true_div(step, max(cfg.warmup_steps, 1)), 1.0)
    prog = torch.clamp(true_div(step - cfg.warmup_steps,
                                max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares, leaf sums added in the reference's
    (sorted) leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def apply(cfg: AdamWConfig, params, state: AdamWState, grads):
    """One AdamW update; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32,
                      device=gnorm.device)
    scale = torch.clamp_max(clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * g32 * g32
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {
        "grad_norm": gnorm, "lr": lr,
    }
