"""Deterministic synthetic data pipeline with distributed semantics.

Counterpart of ``repro.data.pipeline``.  Next-token-prediction batches
come from a counter-based PRNG, so:

* every (step, host) pair regenerates identical data — restart-safe
  without data-loader checkpoints (the loader state IS the step number);
* per-host sharding: host h of H draws rows [h*B/H, (h+1)*B/H) of the
  global batch;
* an optional "straggler" hook simulates slow shards for the mitigation
  policy (``runtime/straggler.py``).

A light Zipf-ish token distribution plus a copy-structure (spans repeated
within a sequence) make the synthetic stream learnable.  The tokens are
made by the reference's numpy code, copied as it is, so a batch is
bit-equal to the reference's; it lands as int32 tensors on ``device``.
Encoder-decoder archs also get stub frame embeddings, and VLMs a stub
image prefix, from the reference's numpy draws rounded to bf16.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import LMConfig, ShapeSpec


@dataclass
class DataConfig:
    seed: int = 1234
    zipf_alpha: float = 1.1
    copy_span: int = 64       # repeated span length (learnable structure)
    num_hosts: int = 1
    host_id: int = 0


def _token_batch(cfg: LMConfig, rows: int, seq: int, step: int,
                 dcfg: DataConfig) -> np.ndarray:
    """Counter-based deterministic token generation (numpy, host-side)."""
    rng = np.random.default_rng(
        np.uint64(dcfg.seed) + np.uint64(step) * np.uint64(1_000_003)
        + np.uint64(dcfg.host_id) * np.uint64(7_919))
    # Zipf-ish marginal over the vocab via inverse-power transform
    u = rng.random((rows, seq))
    ranks = np.floor((cfg.vocab - 1) * u ** dcfg.zipf_alpha).astype(np.int64)
    toks = ranks % cfg.vocab
    # inject copy structure: second span repeats the first
    span = min(dcfg.copy_span, seq // 2)
    if span > 0:
        toks[:, span:2 * span] = toks[:, :span]
    return toks.astype(np.int32)


def make_batch(cfg: LMConfig, shape: ShapeSpec, step: int,
               dcfg: Optional[DataConfig] = None,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Batch for this host at ``step`` (host's slice of the global batch);
    ``labels`` is the same tensor as ``tokens``."""
    dcfg = dcfg or DataConfig()
    B = shape.global_batch // dcfg.num_hosts
    S = shape.seq_len

    def tokens(seq):
        toks = torch.from_numpy(_token_batch(cfg, B, seq, step, dcfg)).to(device)
        return {"tokens": toks, "labels": toks}

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    if cfg.is_encdec():
        dec = max(S // cfg.dec_len_ratio, 8)
        rng = np.random.default_rng(dcfg.seed + step)
        frames = rng.standard_normal((B, S, cfg.enc_frame_dim),
                                     dtype=np.float32)
        return {"enc_frames": bf16(frames), **tokens(dec)}
    if cfg.num_prefix_tokens:
        text = S - cfg.num_prefix_tokens
        rng = np.random.default_rng(dcfg.seed + step)
        prefix = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.prefix_dim), dtype=np.float32)
        return {"prefix": bf16(prefix), **tokens(text)}
    return tokens(S)


class DataIterator:
    """Stateless-resumable iterator: ``DataIterator(cfg, shape, start_step)``
    regenerates exactly the stream a crashed run would have continued."""

    def __init__(self, cfg: LMConfig, shape: ShapeSpec, start_step: int = 0,
                 dcfg: Optional[DataConfig] = None,
                 delay_fn: Optional[Callable[[int], float]] = None,
                 device="cuda") -> None:
        self.cfg = cfg
        self.shape = shape
        self.step = start_step
        self.dcfg = dcfg or DataConfig()
        self.delay_fn = delay_fn      # straggler simulation hook
        self.device = device

    def __iter__(self) -> "DataIterator":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self.delay_fn is not None:
            d = self.delay_fn(self.step)
            if d > 0:
                time.sleep(d)
        batch = make_batch(self.cfg, self.shape, self.step, self.dcfg,
                           self.device)
        self.step += 1
        return batch
