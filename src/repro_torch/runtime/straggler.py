"""Straggler mitigation: deadline-based batch substitution.

Counterpart of ``repro.runtime.straggler``, copied as it is.  On large
fleets the step clock must never stall on one slow host / data shard:

* each step has a soft deadline (EMA of recent step times x slack);
* a batch that misses the deadline is *dropped* and replaced by the
  deterministic stand-in batch for that step (counter-based pipeline =>
  every host can generate it locally, no coordination needed), made on
  ``device``;
* drop events are counted and exposed; persistent stragglers trigger the
  caller's escalation hook instead of unbounded drops.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional

from ..configs.base import LMConfig, ShapeSpec
from ..data.pipeline import DataConfig, make_batch


@dataclass
class StragglerPolicy:
    slack: float = 3.0            # deadline = slack * EMA(step time)
    ema_alpha: float = 0.2
    min_deadline_s: float = 0.05
    escalate_after: int = 8       # consecutive drops -> escalate

    ema: float = field(default=0.0, init=False)
    drops: int = field(default=0, init=False)
    consecutive: int = field(default=0, init=False)
    escalations: int = field(default=0, init=False)

    def deadline(self) -> float:
        return max(self.min_deadline_s, self.slack * self.ema)

    def observe(self, dt: float) -> None:
        self.ema = dt if self.ema == 0.0 else \
            (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt

    def record_drop(self) -> bool:
        """Returns True when the caller should escalate (reschedule)."""
        self.drops += 1
        self.consecutive += 1
        if self.consecutive >= self.escalate_after:
            self.escalations += 1
            self.consecutive = 0
            return True
        return False

    def record_ok(self) -> None:
        self.consecutive = 0


class DeadlineDataIterator:
    """Wraps a (possibly slow) batch source with the deadline policy."""

    def __init__(self, cfg: LMConfig, shape: ShapeSpec,
                 source: Iterator, policy: Optional[StragglerPolicy] = None,
                 dcfg: Optional[DataConfig] = None,
                 on_escalate: Optional[Callable[[], None]] = None,
                 device="cuda") -> None:
        self.cfg = cfg
        self.shape = shape
        self.source = source
        self.policy = policy or StragglerPolicy()
        self.dcfg = dcfg or DataConfig()
        self.on_escalate = on_escalate
        self.device = device
        self.step = getattr(source, "step", 0)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        t0 = time.time()
        deadline = self.policy.deadline()
        batch = next(self.source)
        dt = time.time() - t0
        if self.policy.ema > 0.0 and dt > deadline:
            # too late: substitute the deterministic stand-in for THIS step
            # (the slow batch is discarded; the step clock advances)
            batch = make_batch(self.cfg, self.shape, self.step, self.dcfg,
                               self.device)
            if self.policy.record_drop() and self.on_escalate is not None:
                self.on_escalate()
        else:
            self.policy.record_ok()
            self.policy.observe(dt)
        self.step += 1
        return batch
