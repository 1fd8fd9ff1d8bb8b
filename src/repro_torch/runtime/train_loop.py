"""Checkpointed, failure-tolerant training loop.

Counterpart of ``repro.runtime.train_loop``, with its fault-tolerance
contract:

* **checkpoint/restart** — atomic checkpoints every ``ckpt_every`` steps
  (``repro_torch.checkpoint``, the reference's on-disk layout); on start
  the loop resumes from the newest committed step, and the counter-based
  data pipeline replays the exact stream.
* **step retry** — a step that raises is retried up to ``max_retries``
  times; persistent failure saves a checkpoint before re-raising (so a
  supervisor restart continues cleanly).
* **NaN circuit-breaker** — a non-finite loss rolls back to the last
  checkpoint and skips the offending data step (recorded in the report).

The loop runs on ``device`` (the card unless the caller asks for the
CPU); initial parameters are drawn from ``torch.Generator(device)``
seeded 0.  The train step is functional, so a retried or rolled-back
step never sees half-updated state.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from ..checkpoint import ckpt
from ..configs.base import LMConfig, ShapeSpec
from ..data.pipeline import DataConfig, DataIterator
from ..models.lm import model, transformer
from ..optim import adamw


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_keep: int = 3
    max_retries: int = 2
    log_every: int = 10
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


@dataclass
class TrainReport:
    steps_run: int
    final_step: int
    resumed_from: Optional[int]
    losses: List[float]
    retries: int
    rollbacks: int
    wall_seconds: float


def train(cfg: LMConfig, shape: ShapeSpec, loop: TrainLoopConfig,
          data_cfg: Optional[DataConfig] = None,
          fault_hook: Optional[Callable[[int], None]] = None,
          device="cuda") -> TrainReport:
    """Run (or resume) training; returns a report for tests/examples."""
    t0 = time.time()
    params = transformer.init_params(
        cfg, torch.Generator(device).manual_seed(0), device=device)
    opt_state = adamw.init(params)

    state_like = {"params": params, "opt": opt_state}
    resumed_from = None
    start_step = 0
    restored = ckpt.restore_latest(loop.ckpt_dir, state_like, device)
    if restored is not None:
        start_step, state, _ = restored
        params, opt_state = state["params"], state["opt"]
        resumed_from = start_step

    step_fn = model.make_train_step(cfg, model.TrainStepConfig(opt=loop.opt))

    data = DataIterator(cfg, shape, start_step=start_step, dcfg=data_cfg,
                        device=device)
    losses: List[float] = []
    retries = rollbacks = 0
    step = start_step

    def save(step, params, opt_state):
        ckpt.save(loop.ckpt_dir, step, {"params": params, "opt": opt_state},
                  extras={"arch": cfg.name})
        ckpt.prune(loop.ckpt_dir, keep=loop.ckpt_keep)

    if restored is None:
        save(0, params, opt_state)

    while step < loop.total_steps:
        batch = next(data)
        attempt = 0
        while True:
            try:
                if fault_hook is not None:
                    fault_hook(step)
                new_params, new_opt, metrics = step_fn(params, opt_state,
                                                       batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                params, opt_state = new_params, new_opt
                break
            except FloatingPointError:
                # NaN circuit breaker: rollback + skip the data step
                rollbacks += 1
                restored = ckpt.restore_latest(loop.ckpt_dir, state_like,
                                               device)
                if restored is not None:
                    _, state, _ = restored
                    params, opt_state = state["params"], state["opt"]
                loss = float("nan")
                break
            except Exception:
                attempt += 1
                retries += 1
                if attempt > loop.max_retries:
                    # persistent failure: leave a consistent checkpoint
                    save(step, params, opt_state)
                    raise
        losses.append(loss)
        step += 1
        if step % loop.ckpt_every == 0 or step == loop.total_steps:
            save(step, params, opt_state)
        if loop.log_every and step % loop.log_every == 0:
            print(f"[train] step={step} loss={loss:.4f}")

    return TrainReport(
        steps_run=step - start_step,
        final_step=step,
        resumed_from=resumed_from,
        losses=losses,
        retries=retries,
        rollbacks=rollbacks,
        wall_seconds=time.time() - t0,
    )
