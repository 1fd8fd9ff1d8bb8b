"""The closed loop that drives the port's request, and the checked sample."""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Window(NamedTuple):
    """Host-clock seconds (``time.perf_counter``) of one stretch of
    requests: its start (before the first dispatch), and each request's
    dispatch and completion."""
    start: float
    dispatch: List[float]
    complete: List[float]
    frames_per_request: int


class Sample:
    """A uniform sample of ``k`` of the completed requests' outputs, drawn
    from ``rng`` over a stream of unknown length (reservoir sampling):
    (input batch index, output) pairs."""

    def __init__(self, k: int, rng: random.Random) -> None:
        self.k, self.rng, self.seen = k, rng, 0
        self.kept: List[Tuple[int, object]] = []

    def offer(self, batch: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((batch, out))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (batch, out)
        self.seen += 1


def _waiter(in_flight: int, cuda: bool) -> Tuple[Callable, Callable]:
    """(mark, wait): ``mark()`` after a dispatch, ``wait(marker)`` until
    the card has finished that request.  With one request outstanding the
    wait is ``torch.cuda.synchronize()``; with more, an event recorded
    after the request's dispatch."""
    if not cuda:
        return (lambda: None), (lambda m: None)
    if in_flight == 1:
        return (lambda: None), (lambda m: torch.cuda.synchronize())

    def mark():
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return mark, (lambda ev: ev.synchronize())


def drive(request: Callable, params, inputs: torch.Tensor, order: Sequence[int],
          in_flight: int, sample: Optional[Sample], *, seconds: float = None,
          count: int = None, first: int = 0) -> Window:
    """Send requests ``request(params, inputs[b])``, ``b`` cycling through
    ``order`` from position ``first``, with up to ``in_flight`` of them
    dispatched ahead of the oldest one's completion: until ``seconds`` have
    passed since the start (none is sent after), or ``count`` have been
    sent.  Every request sent is waited for.  Each output is offered to
    ``sample``."""
    mark, wait = _waiter(in_flight, inputs.device.type == "cuda")
    dispatch: List[float] = []
    complete: List[float] = []
    pending: deque = deque()
    sent = 0
    start = time.perf_counter()

    def more() -> bool:
        if count is not None:
            return sent < count
        return time.perf_counter() - start < seconds

    while True:
        while len(pending) < in_flight and more():
            b = order[(first + sent) % len(order)]
            t = time.perf_counter()
            out = request(params, inputs[b])
            pending.append((b, t, out, mark()))
            sent += 1
        if not pending:
            break
        b, t, out, m = pending.popleft()
        wait(m)
        complete.append(time.perf_counter())
        dispatch.append(t)
        if sample is not None:
            sample.offer(b, out)
    return Window(start, dispatch, complete, inputs.shape[1])
