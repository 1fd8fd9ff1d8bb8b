"""Spans of a served request, kept by the request object that serves it.

A :class:`RequestSpans` is kept as ``.spans`` by each served CNN request
object (``executor.GraphedExecute``, ``yolo.GraphedForward``), which runs
every request (:meth:`RequestSpans.request`) and every capture
(:meth:`RequestSpans.capture`) through it.  It records:

* **every request**: a sequence id (the span id its phases share),
  ``t_call`` on ``time.perf_counter`` (the clock a caller's loop reads) and
  the host seconds of the request's three phases: ``copy_in`` (the input
  copied into the graph's static input), ``replay`` (the graph's launch,
  with the launch counts where the object keeps them) and ``copy_out`` (the
  outputs copied out of the graph's static buffers).  Records go into a ring
  of ``CAPACITY`` records, the oldest overwritten, so memory stays fixed
  however long a server runs.
* **every ``sample_every``-th request** (``SAMPLE_EVERY`` on a CUDA device,
  none off one or where it is 0): its device span, between two timing
  events recorded on the request's stream outside the graph, one before
  ``copy_in`` and one after ``copy_out``.  The events come from a pool of up
  to ``EVENT_PAIRS`` pairs, made as they are first needed.  A span is read
  when records are read, or when its pair is reused while its request is
  still kept, never by the request that recorded it; a pair whose end the
  card has not reached when it is reused is dropped, so no request waits on
  the card for a span.  The events cost an H100's host some 30 µs a sampled
  request, against ~2 µs for the stamps, hence the sparse default.
* **every capture**: its key and the host seconds of its parts
  (:class:`Capture`).
* **profiler ranges, only while a profiler runs** (checked once a request
  and once a capture): each phase inside a range named in
  ``REQUEST_RANGES``, each capture part inside one of ``CAPTURE_RANGES``.
  They share the profiler's clock with the device trace, so an idle gap
  inside a traced request can be named by its phase.  They are function
  ranges, not ``record_function``'s user ranges: the profiler mirrors a
  user range onto the device's timeline, where a reader of the device's
  operations would count it as work.  With no profiler running no range
  is entered.

:meth:`RequestSpans.records` returns the records whose ``t_call`` lies in a
host-clock interval.  A request object is called from one thread.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from .kernels import _build

CAPACITY = 1 << 17
SAMPLE_EVERY = 32
EVENT_PAIRS = CAPACITY // SAMPLE_EVERY   # at the default rate a pair's
                                         # request has left the ring by reuse
REQUEST_RANGES = ("repro_torch.request.copy_in", "repro_torch.request.replay",
                  "repro_torch.request.copy_out")
CAPTURE_RANGES = ("repro_torch.capture.warmup", "repro_torch.capture.record")

_profiler_enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter
_stream_data = getattr(torch._C, "_cuda_getCurrentStream", None)


class Request(NamedTuple):
    """One served request's record; times in seconds."""
    id: int
    t_call: float               # host clock as the request's phases begin
    copy_in_s: float
    replay_s: float
    copy_out_s: float
    device_s: Optional[float]   # the device span, where the request was sampled


class Capture(NamedTuple):
    """One capture's parts on the host clock, in seconds.  ``seconds`` is
    ``copy_s + warmup_s + record_s``."""
    key: tuple
    t_start: float
    copy_s: float     # the static input's copy
    warmup_s: float   # the side stream's warm-up run, as the host sees it
    build_s: float    # of warmup_s, the seconds spent in nvcc
    record_s: float   # torch.cuda.graph's entry (it waits for the warm-up's
                      # kernels), the recording and the instantiation
    seconds: float


def _ranged(name: str, fn: Callable) -> Callable:
    def call(*args):
        with _range(name):
            return fn(*args)
    return call


class _RangedCopy:
    """A static input whose ``copy_`` runs inside a range."""

    def __init__(self, static_x: torch.Tensor) -> None:
        self.copy_ = _ranged(REQUEST_RANGES[0], static_x.copy_)


class _CaptureParts:
    """The stamps of one capture in progress: its start, its warm-up's
    start and its recording's start."""

    def __init__(self) -> None:
        self.profiling = _profiler_enabled()
        self.stamps = [_clock()]
        self.build_s = 0.0

    def _range(self, name: str):
        return _range(name) if self.profiling else contextlib.nullcontext()

    @contextlib.contextmanager
    def warmup(self):
        self.stamps.append(_clock())
        built = _build.build_seconds
        with self._range(CAPTURE_RANGES[0]):
            yield
        self.build_s = _build.build_seconds - built

    @contextlib.contextmanager
    def record(self):
        self.stamps.append(_clock())
        with self._range(CAPTURE_RANGES[1]):
            yield


class RequestSpans:
    """The spans of one served request object; see the module's docstring."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.count = 0                       # requests recorded
        self.captures: List[Capture] = []
        # each kept request's stamps: its call, the ends of its three phases
        self._stamps: deque = deque(maxlen=CAPACITY)
        self._append = self._stamps.append
        self.sample_every = SAMPLE_EVERY if device.type == "cuda" else 0
        # device spans read, by request id, in rising order
        self._device: Dict[int, float] = {}
        # [start event, end event, id of the request they span or -1]
        self._pairs: List[Optional[list]] = [None] * EVENT_PAIRS
        self._samples = 0
        self._stream_data = self._stream = None

    @property
    def sample_every(self) -> int:
        return self._every

    @sample_every.setter
    def sample_every(self, every: int) -> None:
        """Sample every ``every``-th request from the next multiple of it
        on; none where it is 0."""
        self._every = every
        self._next_sample = -(-self.count // every) * every if every else -1

    @property
    def capture_seconds(self) -> List[float]:
        return [c.seconds for c in self.captures]

    @contextlib.contextmanager
    def capture(self, key: tuple):
        """A context for one capture of ``key``'s graph: the body copies
        the static input, then runs the warm-up inside ``parts.warmup()``
        and the recording inside ``parts.record()``.  Recorded when the
        body returns, not where it raises."""
        parts = _CaptureParts()
        yield parts
        end = _clock()
        t0, t_warm, t_rec = parts.stamps
        self.captures.append(Capture(key, t0, t_warm - t0, t_rec - t_warm,
                                     parts.build_s, end - t_rec, end - t0))

    def request(self, static_x: torch.Tensor, x: torch.Tensor,
                replay: Callable[[], None], copy_out: Callable):
        """One request: ``static_x.copy_(x)``, ``replay()``, and
        ``copy_out()``'s result returned, each phase timed."""
        if _profiler_enabled():
            static_x = _RangedCopy(static_x)
            replay = _ranged(REQUEST_RANGES[1], replay)
            copy_out = _ranged(REQUEST_RANGES[2], copy_out)
        n = self.count
        pair = None
        if n == self._next_sample:
            self._next_sample = n + self._every
            pair = self._take_pair()
            pair[0].record(self._current_stream())
        t0 = _clock()
        static_x.copy_(x)
        t1 = _clock()
        replay()
        t2 = _clock()
        out = copy_out()
        t3 = _clock()
        if pair is not None:
            pair[1].record(self._stream)
            pair[2] = n
        self._append((t0, t1, t2, t3))
        self.count = n + 1
        return out

    def _current_stream(self) -> "torch.cuda.Stream":
        """The device's current stream, its object made again only where
        another stream has become current (``torch.cuda.current_stream``
        makes one each call, several µs of host time)."""
        index = self.device.index
        data = _stream_data(torch.cuda.current_device() if index is None else index)
        if data != self._stream_data:
            self._stream_data = data
            self._stream = torch.cuda.Stream(stream_id=data[0], device_index=data[1],
                                             device_type=data[2])
        return self._stream

    def _take_pair(self) -> list:
        slot = self._samples % len(self._pairs)
        self._samples += 1
        pair = self._pairs[slot]
        if pair is None:
            pair = self._pairs[slot] = [torch.cuda.Event(enable_timing=True),
                                        torch.cuda.Event(enable_timing=True), -1]
        else:
            self._resolve(pair, wait=False)
        return pair

    def _resolve(self, pair: list, wait: bool) -> None:
        """Keep the span of ``pair``'s request, where the request is still
        kept: after waiting for its end event (``wait``), or only where the
        card has reached it."""
        n, pair[2] = pair[2], -1
        first = self.count - len(self._stamps)
        if n < first:
            return
        if wait:
            pair[1].synchronize()
        elif not pair[1].query():
            return
        self._device[n] = pair[0].elapsed_time(pair[1]) / 1e3
        while next(iter(self._device)) < first:
            del self._device[next(iter(self._device))]

    def records(self, since: float = -math.inf,
                until: float = math.inf) -> List[Request]:
        """The kept records whose ``t_call`` lies in [since, until], oldest
        first, every sampled device span read (waiting for the card where
        a span has not ended)."""
        for pair in self._pairs:
            if pair is not None:
                self._resolve(pair, wait=True)
        first = self.count - len(self._stamps)
        self._device = {n: self._device[n] for n in sorted(self._device) if n >= first}
        return [Request(n, t0, t1 - t0, t2 - t1, t3 - t2, self._device.get(n))
                for n, (t0, t1, t2, t3) in enumerate(self._stamps, first)
                if since <= t0 <= until]
