"""The served CNN requests' spans (``repro_torch.spans``), on the CPU.

``executor.GraphedExecute`` and ``yolo.GraphedForward`` keep a
``RequestSpans`` as ``.spans`` and run each request and each capture
through it.  Held here, with stand-ins for the CUDA graph machinery and
for the timing events (a capture and an event need the card):

* one record a call, ids rising, ``t_call`` inside the call, and phases of
  0 or more whose sum is no more than the call's wall;
* a device span on every ``sample_every``-th record only, none and no event
  made where sampling is off (the default off the card), no wait on the
  card inside a call, and a span whose end the card has not reached when
  its events are reused dropped rather than waited for;
* the ring keeping its last ``CAPACITY`` (2^17) records, and ``records``
  selecting by ``t_call``;
* the three ``repro_torch.request.*`` ranges under a CPU profiler, once a
  request, and no ``record_function`` entered without one;
* a capture's parts adding up to its ``capture_seconds``, with the seconds
  ``nvcc`` took inside the warm-up; and ``_build.build`` adding up its
  compiles' wall seconds.
"""

import contextlib
import itertools
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.cnn import executor, graphs, resnet, yolo  # noqa: E402

CUDA = torch.device("cuda")   # a device object only: nothing runs on it


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StandInStream:
    def wait_stream(self, other):
        pass


class _StandInEvent:
    """A timing event: ``record`` stamps the next tick of a shared clock
    (1 ms apart), ``query`` says whether the card has reached it (as
    ``reached`` says), ``elapsed_time`` is the ticks between two stamps;
    every event made and every wait on one is counted."""
    ticks = itertools.count()
    made = 0
    waits = 0
    reached = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        assert isinstance(stream, _StandInStream)
        self.at = float(next(self.ticks))

    def query(self):
        return self.reached

    def synchronize(self):
        type(self).waits += 1

    def elapsed_time(self, end):
        return end.at - self.at


def _no_wait(*args, **kwargs):
    raise AssertionError("a request waited for the card")


@pytest.fixture
def stand_ins(monkeypatch):
    """The CUDA graph machinery, the timing events and the card check
    stood in for on the CPU; ``torch.cuda.synchronize`` fails the test."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda **kwargs: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(spans, "_stream_data", lambda index: (3, index, 1))
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_wait)
    monkeypatch.setattr(_StandInEvent, "made", 0)
    monkeypatch.setattr(_StandInEvent, "waits", 0)
    monkeypatch.setattr(_StandInEvent, "reached", True)
    for module in (executor, yolo):
        monkeypatch.setattr(module, "_card_of", lambda params: torch.device("cpu"))


def _resnet8():
    cfg = resnet.RESNET8
    params = resnet.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    graphed = executor.GraphedExecute(graphs.build_resnet_graph(cfg), params)
    return graphed, params, torch.rand((1, 32, 32, 3), generator=torch.Generator().manual_seed(1))


def _yolov8n():
    params = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    graphed = yolo.GraphedForward(params, (64, 64))
    return graphed, params, torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))


REQUESTS = {"GraphedExecute": _resnet8, "GraphedForward": _yolov8n}


@pytest.fixture(params=list(REQUESTS))
def served(request, stand_ins):
    return REQUESTS[request.param]()


class _Static:
    """A static input whose copy costs nothing."""

    def copy_(self, x):
        pass


def _spans(device, every):
    rs = spans.RequestSpans(device)
    rs.sample_every = every
    return rs


def _serve(rs, n, replay=lambda: None):
    for _ in range(n):
        rs.request(_Static(), None, replay, lambda: None)


def test_one_record_a_call_with_its_phases_inside_the_call(served):
    graphed, params, x = served
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        graphed(params, x)
        walls.append((t0, time.perf_counter()))
    recs = graphed.spans.records()
    assert [r.id for r in recs] == list(range(6))
    for r, (t0, t1) in zip(recs, walls):
        assert t0 <= r.t_call <= t1
        phases = (r.copy_in_s, r.replay_s, r.copy_out_s)
        assert min(phases) >= 0 and sum(phases) <= t1 - t0
        assert r.device_s is None            # off the card: no sampling
    assert _StandInEvent.made == 0
    assert graphed.spans.sample_every == 0
    assert spans.RequestSpans(CUDA).sample_every == spans.SAMPLE_EVERY == 32


def test_a_device_span_on_every_fourth_request_and_no_wait_in_a_call(served):
    graphed, params, x = served
    graphed.spans.sample_every = 4
    for _ in range(10):
        graphed(params, x)
    assert _StandInEvent.waits == 0 and _StandInEvent.made == 2 * 3
    recs = graphed.spans.records()
    assert [r.id for r in recs if r.device_s is not None] == [0, 4, 8]
    # each span is its own pair's ticks apart: a stamp before the copy in,
    # one after the copy out, and no other request's stamp between them
    assert all(r.device_s == pytest.approx(1e-3) for r in recs if r.device_s)


def test_the_stream_object_is_made_again_only_for_another_stream(stand_ins,
                                                                  monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda **kw: made.append(kw) or _StandInStream())
    current = [(3, 0, 1)]
    monkeypatch.setattr(spans, "_stream_data", lambda index: current[0])
    rs = _spans(CUDA, 1)
    _serve(rs, 3)
    current[0] = (5, 0, 1)
    _serve(rs, 2)
    assert made == [{"stream_id": 3, "device_index": 0, "device_type": 1},
                    {"stream_id": 5, "device_index": 0, "device_type": 1}]


def test_sampling_off_makes_no_event(stand_ins):
    rs = _spans(CUDA, 0)
    _serve(rs, 9)
    assert _StandInEvent.made == 0
    assert all(r.device_s is None for r in rs.records())
    assert spans.RequestSpans(torch.device("cpu")).sample_every == 0


def test_spans_are_read_when_their_events_are_reused(stand_ins, monkeypatch):
    """With two pairs, the third sampled request reuses the first's pair
    and reads its span there; a pair the card has not reached is dropped,
    not waited for."""
    monkeypatch.setattr(spans, "EVENT_PAIRS", 2)
    rs = _spans(CUDA, 1)
    _serve(rs, 3)
    assert _StandInEvent.made == 4 and _StandInEvent.waits == 0
    assert rs._device[0] == pytest.approx(1e-3)       # read at the reuse
    _StandInEvent.reached = False
    _serve(rs, 1)                                     # reuses request 1's pair
    assert _StandInEvent.waits == 0
    _StandInEvent.reached = True
    recs = rs.records()                               # reading waits
    assert [r.device_s is not None for r in recs] == [True, False, True, True]
    assert _StandInEvent.waits == 2


def test_the_ring_keeps_its_last_capacity_records(stand_ins):
    assert spans.CAPACITY == 1 << 17
    rs = spans.RequestSpans(CUDA)
    _serve(rs, spans.CAPACITY + 5)
    recs = rs.records()
    assert len(recs) == spans.CAPACITY and rs.count == spans.CAPACITY + 5
    assert recs[0].id == 5 and recs[-1].id == spans.CAPACITY + 4
    assert all(b.t_call >= a.t_call for a, b in zip(recs, recs[1:]))
    sampled = [r.id for r in recs if r.device_s is not None]
    assert sampled == list(range(32, spans.CAPACITY + 5, 32))
    assert _StandInEvent.made == 2 * spans.EVENT_PAIRS
    assert _StandInEvent.waits == spans.EVENT_PAIRS    # reading waits


def test_records_select_by_t_call(stand_ins):
    rs = spans.RequestSpans(CUDA)
    _serve(rs, 40, replay=lambda: time.sleep(1e-4))
    every = rs.records()
    since, until = every[10].t_call, every[29].t_call
    assert [r.id for r in rs.records(since, until)] == list(range(10, 30))
    assert rs.records(until=since) == every[:11]
    assert rs.records(since=every[-1].t_call + 1) == []


def _range_names(prof):
    """The spans' ranges a profile holds; each a function range (scope 0),
    which the profiler does not mirror onto the device's timeline as it
    does a user range (``record_function``'s, scope 7)."""
    ranges = [e for e in prof.events()
              if e.name.startswith(("repro_torch.request.", "repro_torch.capture."))]
    assert all(e.scope == 0 for e in ranges)
    return [e.name for e in ranges]


def test_ranges_only_while_a_profiler_runs(served, monkeypatch):
    graphed, params, x = served
    entered = []
    real = spans._range

    def counted(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(spans, "_range", counted)
    graphed(params, x)                       # the capture, then a request
    graphed(params, x)
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            graphed(params, x)
    names = _range_names(prof)
    assert sorted(names) == sorted(spans.REQUEST_RANGES * 3)
    assert len(graphed.spans.records()) == 5

    fresh, params, x = REQUESTS[type(graphed).__name__]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fresh(params, x)
    assert sorted(_range_names(prof)) == sorted(spans.CAPTURE_RANGES
                                                + spans.REQUEST_RANGES)


def test_a_captures_parts_add_up_to_its_seconds(served, monkeypatch):
    graphed, params, x = served
    runs = []

    def building(run):
        def call(*args):
            if not runs:                     # the warm-up builds
                _build.build_seconds += 0.25
            runs.append(1)
            return run(*args)
        return call
    if isinstance(graphed, executor.GraphedExecute):
        monkeypatch.setattr(executor, "run_int8", building(executor.run_int8))
    else:
        monkeypatch.setattr(graphed, "_run", building(graphed._run))
    monkeypatch.setattr(_build, "build_seconds", 1.0)
    t0 = time.perf_counter()
    graphed(params, x)
    wall = time.perf_counter() - t0
    c, = graphed.spans.captures
    assert c.key == (tuple(x.shape), x.dtype) and len(runs) == 2
    assert min(c.copy_s, c.warmup_s, c.record_s) >= 0
    assert c.copy_s + c.warmup_s + c.record_s == pytest.approx(c.seconds, abs=1e-12)
    assert graphed.capture_seconds == [c.seconds] and c.seconds <= wall
    assert c.build_s == pytest.approx(0.25)  # stood in: no time passes
    graphed(params, torch.cat([x, x]))       # a new key: a second capture
    assert len(graphed.capture_seconds) == 2
    assert graphed.spans.captures[1].build_s == 0.0


def test_build_adds_its_compiles_wall_seconds(monkeypatch, tmp_path):
    class _Nvcc:
        def __init__(self, cmd, stdout=None, stderr=None):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def wait(self):
            time.sleep(0.05)
            return 0
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _Nvcc)
    monkeypatch.setattr(_build, "build_seconds", 0.0)
    _build.build(["imc_mvm"])
    assert _build.build_seconds >= 0.05
    built = _build.build_seconds
    _build.build(["imc_mvm"])                # the library is there
    assert _build.build_seconds == built
