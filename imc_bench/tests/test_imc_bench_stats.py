"""The metrics' arithmetic on made-up samples and traces."""

import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from imc_bench import loop, spec, stats, trace
from imc_bench.trace import Op, Traced

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("n,p", [(0, None), (19, None), (20, 50), (100, 90),
                                 (199, 94), (200, 95), (1000, 99), (10000, 99)])
def test_tail_percentile_rule(n, p):
    assert stats.tail_percentile(n) == p
    if p is not None:
        assert n * (100 - p) / 100 >= 10 and n * (100 - p - 1) / 100 < 10


def test_percentile_against_numpy():
    rng = random.Random(5)
    for n in (1, 2, 7, 200, 1001):
        xs = [rng.expovariate(1.0) for _ in range(n)]
        for p in (0, 25, 50, 95, 99, 100):
            assert stats.percentile(xs, p) == pytest.approx(
                float(np.percentile(xs, p)), rel=1e-12)


def test_interval_union_and_gaps():
    ivs = [(1, 3), (2, 4), (6, 7), (6.5, 6.8), (9, 12), (-2, 0.5)]
    window = (0, 10)
    assert stats.merged(ivs, window) == [(0, 0.5), (1, 4), (6, 7), (9, 10)]
    assert stats.covered(ivs, window) == pytest.approx(5.5)
    assert stats.gaps(ivs, window) == [(0.5, 1), (4, 6), (7, 9)]
    assert stats.covered([], window) == 0 and stats.gaps([], window) == [window]


def _traced():
    """Two requests in a 10 ms window: each an INT8 conv, a glue kernel and
    a copy, with the host in a sync or a graph launch in the gaps."""
    ops = [Op("Memcpy DtoD (Device -> Device)", 0.001, 0.0015),
           Op("void imc_conv2d_kernel<1>", 0.0015, 0.0035),
           Op("vectorized_elementwise_kernel", 0.0030, 0.0040),
           Op("Memcpy DtoD (Device -> Device)", 0.005, 0.0055),
           Op("void imc_conv2d_kernel<1>", 0.0055, 0.0075),
           Op("vectorized_elementwise_kernel", 0.0075, 0.0085),
           Op("void cudnn::nhwcToNchwKernel", 0.0085, 0.009),
           Op("late kernel", 0.0098, 0.0110)]
    host = [Op("cudaGraphLaunch", 0.0, 0.001), Op("cudaDeviceSynchronize", 0.004, 0.005),
            Op("aten::copy_", 0.0092, 0.0096)]
    return Traced(ops, host, (0.0, 0.010), 2, 512)


def test_busy_device_seconds_and_breakdown():
    t = _traced()
    assert trace.busy_seconds(t) == pytest.approx(0.001 * 3 + 0.004 + 0.0002)
    assert trace.device_seconds(t, lambda o: "imc_conv2d" in o.name) == \
        pytest.approx(0.004)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["void imc_conv2d_kernel<1>", pytest.approx(0.004)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"host: cudaGraphLaunch": pytest.approx(0.001),
                    "host: cudaDeviceSynchronize": pytest.approx(0.001),
                    "host: aten::copy_": pytest.approx(0.0008)}
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def _run(traced, config=None, traffic=None, request=None):
    cell = SimpleNamespace(config=config or {}, traffic=traffic or {},
                           reference=spec.load_module(
                               ROOT / "imc_bench" / "reference" / "resnet18-cifar-int8.py"))
    window = loop.Window(0.0, [0.0, 0.1, 0.2], [0.1, 0.2, 0.4], 256)
    return SimpleNamespace(cell=cell, traced=traced, window=window,
                           request=request, setup_s=7.5)


def _read(name, run):
    return spec.reader(ROOT, name)(run)


def _with(run, **kw):
    return SimpleNamespace(**{**vars(run), **kw})


def test_readers_on_a_made_up_trace():
    cfg = {"ops_per_frame": 1e9, "peak_ops_per_s": 1e15, "hbm_bytes_per_s": 3e12,
           "stem_width": 32, "stage_widths": [32, 64, 128, 256],
           "blocks_per_stage": [2, 2, 2, 2], "num_classes": 10, "image_hw": [32, 32]}
    run = _run(_traced(), cfg, {"frames_per_request": 256},
               SimpleNamespace(capture_seconds=[0.25, 0.5]))
    busy = 0.0072
    assert _read("device_idle_pct.stream", run) == pytest.approx(100 * (1 - busy / 0.01))
    wall = (0.1 + 0.1 + 0.2) / 3   # the untraced window's mean request
    assert _read("device_idle_pct.frame", run) == pytest.approx(100 * (1 - busy / 2 / wall))
    slow = run.traced._replace(window=(-0.5, 0.010))   # a slice the profiler slowed
    assert _read("device_idle_pct.frame", _with(run, traced=slow)) == \
        _read("device_idle_pct.frame", run)
    assert _read("launches_per_request.frame", run) == pytest.approx(6 / 2)
    assert _read("int8_glue_ms", run) == pytest.approx(1e3 * 0.0037 / 2)
    assert _read("layout_convert_ms", run) == pytest.approx(1e3 * 0.0005 / 2)
    assert _read("mfu_pct", run) == pytest.approx(100 * 1e9 * 512 / (0.01 * 1e15))
    assert _read("capture_s", run) == 0.75
    from imc_bench import work
    least = sum(work.bound_s(*work.conv_work(s), 1e15, 3e12)
                for s in run.cell.reference.conv_shapes(cfg, 256))
    assert _read("imc_conv2d_roofline", run) == pytest.approx(100 * least * 2 / 0.004)
    assert _read("frames_per_s", run) == pytest.approx(3 * 256 / 0.4)
    assert _read("setup_s", run) == 7.5


def test_readers_with_nothing_to_read_return_none():
    empty = Traced([], [], (0.0, 1.0), 3, 3)
    for trc in (None, empty):
        run = _run(trc, {"ops_per_frame": 1, "peak_ops_per_s": 1}, {}, lambda p, x: x)
        for name in ("device_idle_pct.stream", "device_idle_pct.frame", "mfu_pct",
                     "launches_per_request.frame",
                     "int8_glue_ms", "imc_conv2d_roofline", "layout_convert_ms",
                     "capture_s"):
            assert _read(name, run) is None, name
    run = _run(None)
    run.window = loop.Window(0.0, [0.0] * 199, [0.001] * 199, 1)
    assert _read("latency_p95_ms", run) is None
    run.window = loop.Window(0.0, [0.0] * 200, [i * 1e-5 for i in range(200)], 1)
    assert _read("latency_p95_ms", run) == pytest.approx(
        1e3 * float(np.percentile([i * 1e-5 for i in range(200)], 95)))


def test_reservoir_sample_is_uniform_and_bounded():
    counts = [0] * 20
    for seed in range(2000):
        s = loop.Sample(5, random.Random(seed))
        for i in range(20):
            s.offer(i, i)
        assert s.seen == 20 and len(s.kept) == 5
        for b, _ in s.kept:
            counts[b] += 1
    assert min(counts) > 0.8 * 500 and max(counts) < 1.2 * 500
