"""Batched serving loop: continuous-batching-style request scheduler over
the prefill/decode steps.

Counterpart of ``repro.runtime.serve_loop``.  Requests arrive with
prompts; the server packs up to ``max_batch`` of them, left-pads the
prompts with token 0 to the widest (the pads are attended to, and
positions count from the first pad, as in the reference), prefills once,
then decodes in lockstep, retiring sequences on EOS or length budget.
Fault tolerance: a decode-step failure (``RuntimeError``) re-runs prefill
for the live slots with everything generated so far (caches are
reconstructible state, never durable).  The server runs on the device of
the parameters it is given.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..configs.base import LMConfig
from ..models.lm import model


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor         # (S,) integer token ids
    max_new: int = 16
    eos: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    served: int = 0
    prefills: int = 0
    decode_steps: int = 0
    retries: int = 0
    wall_seconds: float = 0.0


class Server:
    def __init__(self, cfg: LMConfig, params, max_batch: int = 4,
                 s_max: int = 128, fault_hook=None) -> None:
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.s_max = s_max
        self.prefill = model.make_prefill_step(cfg, s_max=s_max)
        self.decode = model.make_decode_step(cfg)
        self.fault_hook = fault_hook

    def _pad_prompts(self, reqs: List[Request]) -> torch.Tensor:
        prompts = [torch.as_tensor(r.prompt, dtype=torch.long) for r in reqs]
        width = max(int(p.shape[0]) for p in prompts)
        rows = [F.pad(p, (width - int(p.shape[0]), 0)) for p in prompts]
        return torch.stack(rows).to(self.device)

    def serve(self, requests: List[Request]) -> ServeStats:
        t0 = time.perf_counter()
        stats = ServeStats()
        queue = list(requests)
        while queue:
            live = queue[: self.max_batch]
            queue = queue[self.max_batch:]
            self._run_batch(live, stats)
            stats.served += len(live)
        stats.wall_seconds = time.perf_counter() - t0
        return stats

    def _run_batch(self, live: List[Request], stats: ServeStats) -> None:
        tokens = self._pad_prompts(live)
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        stats.prefills += 1
        cur = torch.argmax(logits[:, -1:], dim=-1)
        max_new = max(r.max_new for r in live)
        for step in range(max_new):
            host = cur[:, 0].tolist()
            for i, r in enumerate(live):
                if not r.done and len(r.out_tokens) < r.max_new:
                    tok = host[i]
                    r.out_tokens.append(tok)
                    if r.eos is not None and tok == r.eos:
                        r.done = True
                elif len(r.out_tokens) >= r.max_new:
                    r.done = True
            if all(r.done for r in live):
                break
            try:
                if self.fault_hook is not None:
                    self.fault_hook(stats.decode_steps)
                logits, cache = self.decode(self.params, cur, cache)
            except RuntimeError:
                # decode failure: caches are reconstructible — re-prefill
                # with everything generated so far and continue
                stats.retries += 1
                ext = []
                for r in live:
                    prompt = torch.as_tensor(r.prompt, dtype=torch.long)
                    gen = torch.tensor(r.out_tokens, dtype=torch.long,
                                       device=prompt.device)
                    ext.append(torch.cat([prompt, gen]))
                tokens = self._pad_prompts(
                    [Request(r.rid, e, r.max_new) for r, e in zip(live, ext)])
                logits, cache = self.prefill(self.params, {"tokens": tokens})
                stats.prefills += 1
            stats.decode_steps += 1
            cur = torch.argmax(logits[:, -1:], dim=-1)
