"""The readers of the served request's spans on a synthetic run, on the CPU:
``request_device_ms``, ``request_host_ms`` and ``capture_record_s`` read
the port's ``RequestSpans`` (timing events and the host clock stood in
for), only the untraced window's records, and nothing where the request
keeps no spans."""

import itertools
from pathlib import Path

import pytest
import torch

from imc_bench import loop, spec
from imc_bench.run import Run

from repro_torch import spans

ROOT = Path(__file__).resolve().parents[2]
NAMES = ["request_device_ms.stream", "request_device_ms.frame",
         "request_host_ms.frame", "capture_record_s"]


class _Stream:
    pass


class _Event:
    """A timing event whose span is the device seconds ``_Event.next_ms``
    hands out, one a pair."""
    next_ms = None

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self, stream=None):
        if self.ms is None:
            self.ms = next(self.next_ms)

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


class _Clock:
    """The host clock as the spans read it: request k's call at ``10 + k``,
    its phases ``k`` µs, 2k µs and 3k µs long."""

    def __init__(self):
        self.stamps = iter(())

    def __call__(self):
        return next(self.stamps)

    def request(self, k):
        t = 10.0 + k
        self.stamps = iter((t, t + 1e-6 * k, t + 3e-6 * k, t + 6e-6 * k))


class _Served:
    def __init__(self, rs):
        self.spans = rs


@pytest.fixture
def served(monkeypatch):
    """A request object whose spans hold 12 requests at host times 10-21 s,
    every fourth (0, 4, 8) with a device span of 0.1, 0.2 and 0.3 ms, and
    two captures recording for 0.5 and 0.25 s."""
    clock = _Clock()
    monkeypatch.setattr(spans, "_clock", clock)
    monkeypatch.setattr(torch.cuda, "Stream", lambda **kwargs: _Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(spans, "_stream_data", lambda index: (3, index, 1))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "next_ms", itertools.chain.from_iterable(
        (ms, None) for ms in (0.1, 0.2, 0.3)))
    rs = spans.RequestSpans(torch.device("cuda"))
    rs.sample_every = 4
    for k in range(12):
        clock.request(k)
        rs.request(torch.zeros(1), torch.ones(1), lambda: None, lambda: None)
    for record_s in (0.5, 0.25):
        clock.stamps = iter((0.0, 1.0, 2.0, 2.0 + record_s))
        with rs.capture(("x",)) as parts:
            with parts.warmup():
                pass
            with parts.record():
                pass
    return _Served(rs)


def _run(request, start, complete):
    dispatch = [c - 0.5 for c in complete]
    return Run(None, 0.0, loop.Window(start, dispatch, complete, 1), None, request)


def _read(name, run):
    return spec.reader(ROOT, name)(run)


def test_the_readers_read_only_the_windows_records(served):
    # the window holds the requests called at 13-20 s: 3 to 10
    run = _run(served, 12.5, [13.9 + k for k in range(8)])
    assert _read("request_device_ms.stream", run) == pytest.approx(0.25)   # 4 and 8
    assert _read("request_device_ms.frame", run) == pytest.approx(0.25)
    # request k's host phases: 6k µs; the median of k = 3..10 is 6.5 x 6 µs
    assert _read("request_host_ms.frame", run) == pytest.approx(0.039)
    assert _read("capture_record_s", run) == pytest.approx(0.75)
    run = _run(served, 9.0, [10.5])                  # request 0 alone
    assert _read("request_device_ms.frame", run) == pytest.approx(0.1)
    assert _read("request_host_ms.frame", run) == 0.0


def test_the_readers_read_nothing_without_spans_or_requests(served):
    run = _run(served, 13.2, [13.4, 13.6])          # no call inside
    assert _read("request_device_ms.stream", run) is None
    assert _read("request_host_ms.frame", run) is None
    assert _read("request_device_ms.frame", _run(served, 9.0, [])) is None
    plain = _run(lambda p, x: x, 9.0, [30.0])        # the CPU's request
    assert all(_read(name, plain) is None for name in NAMES)
    served.spans.captures.clear()
    assert _read("capture_record_s", _run(served, 9.0, [30.0])) is None
