"""Scheduler registry.

Paper algorithms: lblp (Alg. 1), wb (Alg. 2), rr, rd (§IV).
Beyond-paper:     heft, cpop ([12], related work), optimal (B&B bound),
                  lblp-x (our improved variant).

The port's copy of ``repro.core.schedulers``, with one deliberate
difference: heft, cpop, optimal and lblp-x are registered directly.  The
reference registers them under ``try: ... except ImportError``; here a
missing module is an import error, not a name that silently drops out of
:func:`available`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..cost import CostModel
from .base import Assignment, ScheduleError, Scheduler
from .heft import CPOPScheduler, HEFTScheduler
from .lblp import LBLPScheduler
from .lblp_mt import LBLPMTScheduler
from .lblp_r import LBLPRScheduler, schedule_replicated
from .lblp_x import LBLPXScheduler
from .optimal import OptimalScheduler
from .rd import RDScheduler
from .rr import RRScheduler
from .wb import WBScheduler

_REGISTRY: Dict[str, Callable[..., Scheduler]] = {
    "lblp": LBLPScheduler,
    "lblp-mt": LBLPMTScheduler,
    "lblp-r": LBLPRScheduler,
    "wb": WBScheduler,
    "rr": RRScheduler,
    "rd": RDScheduler,
    "heft": HEFTScheduler,
    "cpop": CPOPScheduler,
    "optimal": OptimalScheduler,
    "lblp-x": LBLPXScheduler,
}


def register(name: str, factory: Callable[..., Scheduler]) -> None:
    _REGISTRY[name] = factory


def get_scheduler(name: str, cost_model: Optional[CostModel] = None,
                  **kw) -> Scheduler:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](cost_model, **kw)


def available() -> list:
    return sorted(_REGISTRY)


__all__ = [
    "Assignment",
    "ScheduleError",
    "Scheduler",
    "LBLPScheduler",
    "LBLPMTScheduler",
    "LBLPRScheduler",
    "WBScheduler",
    "RRScheduler",
    "RDScheduler",
    "get_scheduler",
    "register",
    "available",
    "schedule_replicated",
]
