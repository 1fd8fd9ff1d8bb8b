"""The card-free phases of ``chip_smoke.py`` rehearsed on the CPU: the
main path's INT8 requests (phase 4, with the INT8 ops counting launches
as the card's wrappers do, and its trace gate), the
LM card-against-CPU gate, the YOLOv8n phase (its served request too,
plain on the CPU and as ``GraphedForward`` under stand-ins for the CUDA
graph machinery, with its faults) and the training phases
T1-T3 (smoke widths, T3 at a few steps) with the CPU on both sides, and
the placement phase (schedule and simulate the ResNet-18
graph the main path executes and the YOLOv8n graph; elastic sessions;
the serving control plane; the stage partitioner) against the
reference."""

import contextlib
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models.cnn import graphs as jgraphs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.cnn import graphs  # noqa: E402
from repro_torch.models.lm import transformer  # noqa: E402


def test_lm_gate_compares_tokens_on_cpu():
    cfg = get_config("gemma3-1b").smoke()
    out = chip_smoke.lm_card_vs_cpu(cfg, torch.device("cpu"), 12, 3)
    assert out["worst_rel"] == 0.0
    assert 1 <= out["tokens_compared"] <= 4


def test_lm_gate_fails_when_no_token_is_compared(monkeypatch):
    """Flat logits leave no top-2 margin at any step: the gate compared
    nothing, and says so instead of passing."""
    cfg = get_config("gemma3-1b").smoke()

    def flat(cfg, params, toks, *rest):
        return torch.ones((toks.shape[0], toks.shape[1], cfg.vocab)), None

    monkeypatch.setattr(transformer, "prefill", flat)
    monkeypatch.setattr(transformer, "decode", flat)
    with pytest.raises(AssertionError, match="no greedy token compared"):
        chip_smoke.lm_card_vs_cpu(cfg, torch.device("cpu"), 8, 2)


def _counting_kernels(monkeypatch):
    """The INT8 ops on the CPU counting a launch as the card's wrappers do
    (on the instance the rule names), so the phase's count gates can be
    rehearsed; the counters are restored after the test."""
    from repro_torch.kernels import conv2d, ops
    from repro_torch.kernels.conv2d import imc_conv2d
    from repro_torch.kernels.imc_mvm import imc_mvm, mvm_instance
    for fn in (imc_conv2d, imc_mvm):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_instance",
                            dict(fn.launches_by_instance))
    conv, mvm = ops.quantized_conv2d, ops.quantized_matmul

    def counted_conv(qx, qw, *args, **kwargs):
        imc_conv2d.launches += 1
        imc_conv2d.launches_by_instance[conv2d.conv_instance(
            qx.shape[3], qw.shape[3], qx.data_ptr() % 16 == 0)] += 1
        return conv(qx, qw, *args, **kwargs)

    def counted_mvm(qx, qw, *args, **kwargs):
        imc_mvm.launches += 1
        imc_mvm.launches_by_instance[mvm_instance(
            qx.shape[1], qx.data_ptr() % 16 == 0)] += 1
        return mvm(qx, qw, *args, **kwargs)
    monkeypatch.setattr(ops, "quantized_conv2d", counted_conv)
    monkeypatch.setattr(ops, "quantized_matmul", counted_mvm)


def _serve_resnet8(n_requests=2):
    from repro_torch.models.cnn import resnet
    return chip_smoke.serve_cnn(resnet.RESNET8, graphs.resnet8_graph(),
                                n_requests, "resnet8", torch.device("cpu"), 4,
                                lambda: None)


def test_cnn_phase_rehearsed_on_cpu(monkeypatch):
    """Phase 4 at ResNet-8, 2 requests of 4 frames, on the CPU: the served
    request is the plain ``execute`` there (``GraphedExecute`` needs the
    card), with the INT8 ops counting launches as the wrappers do."""
    _counting_kernels(monkeypatch)
    rec, (request, params, scales, x) = _serve_resnet8()
    assert rec["launches"] == [2 * 9, 2 * 1] and rec["logits_equal"] == [True] * 2
    assert rec["conv_by_staging"] == [2 * 8, 2 * 1] and rec["capture_s"] == []
    assert rec["cpu_max_abs_d"] == 0.0 and len(rec["latency_ms"]) == 2
    assert rec["requests"] == 2 and rec["batch"] == 4 and x.shape == (4, 32, 32, 3)


@pytest.mark.parametrize("fault", ["launches", "logits", "cpu"])
def test_cnn_phase_fails_when_it_should(fault, monkeypatch):
    """No launch counted, served logits off the plain ones by one ulp's
    worth, and a card whose logits drift from the CPU's each fail phase 4."""
    from repro_torch.models.cnn import executor
    if fault != "launches":
        _counting_kernels(monkeypatch)
    if fault == "logits":
        serve = executor.int8_request

        def shifted(*args):
            request = serve(*args)
            return lambda p, x: torch.nextafter(request(p, x),
                                                torch.tensor(float("inf")))
        monkeypatch.setattr(executor, "int8_request", shifted)
        match = "differs from the plain one"
    elif fault == "cpu":
        plain = executor.execute

        def drifted(g, params, x, **kw):
            y = plain(g, params, x, **kw)
            return y + 1e-3 * y.abs().max() if drifted.on else y
        drifted.on = False
        monkeypatch.setattr(executor, "execute", drifted)
        copy = chip_smoke.to_device

        def to_cpu(tree, dev):
            drifted.on = True     # the run on CPU copies: the plain path
            return copy(tree, dev)
        monkeypatch.setattr(chip_smoke, "to_device", to_cpu)
        match = "disagree with the plain path"
    else:
        match = "launches"
    with pytest.raises(AssertionError, match=match):
        _serve_resnet8()


def test_trace_launches_gate():
    """One replay's trace must show one conv launch a CONV node and one mvm
    launch a MVM node, summed over the kernels' instances by name."""
    rows = [{"name": "void (anonymous namespace)::imc_conv2d_kernel<32, true>(",
             "ms": 0.1, "calls": 12},
            {"name": "void (anonymous namespace)::imc_conv2d_kernel<32, false>(",
             "ms": 0.1, "calls": 1},
            {"name": "void (anonymous namespace)::imc_conv2d_kernel<128, true>(",
             "ms": 0.1, "calls": 7},
            {"name": "void (anonymous namespace)::imc_mvm_kernel<true>(",
             "ms": 0.01, "calls": 1},
            {"name": "void at::native::vectorized_elementwise_kernel<4>",
             "ms": 0.2, "calls": 80}]
    got = chip_smoke.trace_launches(rows)
    assert got == {"imc_conv2d": 20, "imc_mvm": 1}
    chip_smoke.check_trace_launches("resnet18", got, 20, 1)
    for bad in ({"imc_conv2d": 19, "imc_mvm": 1}, {"imc_conv2d": 40, "imc_mvm": 2},
                {"imc_conv2d": 20, "imc_mvm": 0}):
        with pytest.raises(AssertionError, match="trace of one request"):
            chip_smoke.check_trace_launches("resnet18", bad, 20, 1)


def test_placement_phase_equals_reference():
    g18 = graphs.resnet18_graph()
    lblp, rec = chip_smoke.schedule_and_simulate(g18)
    assert set(lblp.mapping) == set(g18.nodes) and len(g18) == 30
    cm = jcore.CostModel()
    rg = jgraphs.resnet18_graph()
    for alg in chip_smoke.PLACE_ALGS:
        ra = jcore.get_scheduler(alg, cm).schedule(
            rg, jcore.make_pus(*chip_smoke.PLACE_FLEET))
        row = rec["schedulers"][alg]
        assert row["mapping"] == {str(k): v for k, v in sorted(ra.mapping.items())}
        for engine in ("exact", "periodic"):
            res = jcore.make_simulator(rg, cm, engine=engine).run(
                ra, frames=chip_smoke.PLACE_FRAMES)
            assert (row[engine]["rate"], row[engine]["latency"],
                    row[engine]["mean_utilization"]) == (
                res.rate, res.latency, res.mean_utilization)
    assert rec["replicated"]["replicas"]
    assert set(rec["multi_tenant"]["tenants"]) == set(chip_smoke.MT_RATES)


# ---------------------------------------------------------------------------
# The rest of phase 3 (YOLOv8n placement, elastic sessions, the serving
# control plane, the stage partitioner) and phase 5b (YOLOv8n in float)
# ---------------------------------------------------------------------------

import hashlib  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import elastic as jelastic  # noqa: E402
from repro.core import pipeline_partition as jpp  # noqa: E402
from repro.core import serving as jserving  # noqa: E402


def test_yolov8n_placement_phase_equals_reference():
    rec = chip_smoke.place_yolov8n()
    assert rec["nodes"] == 233 and rec["fleet"] == [16, 8]
    cm = jcore.CostModel()
    rg = jgraphs.yolov8n_graph()
    for alg in chip_smoke.PLACE_ALGS:
        ra = jcore.get_scheduler(alg, cm).schedule(
            rg, jcore.make_pus(*chip_smoke.YOLO_FLEET))
        for engine in ("exact", "periodic"):
            res = jcore.make_simulator(rg, cm, engine=engine).run(
                ra, frames=chip_smoke.YOLO_FRAMES)
            row = rec["schedulers"][alg][engine]
            assert (row["rate"], row["latency"], row["mean_utilization"]) == (
                res.rate, res.latency, res.mean_utilization)


def test_yolov8n_placement_gate_fails_when_wb_wins(monkeypatch):
    """The gate is live: with the LBLP and WB schedulers swapped, the row
    named LBLP has WB's rate and the phase raises."""
    import repro_torch.core as core
    real = core.get_scheduler
    monkeypatch.setattr(core, "get_scheduler", lambda name, *a, **kw: real(
        {"lblp": "wb", "wb": "lblp"}.get(name, name), *a, **kw))
    with pytest.raises(AssertionError, match="LBLP rate"):
        chip_smoke.place_yolov8n()


def test_elastic_phase_equals_reference():
    rec = chip_smoke.elastic_sessions()
    sess = jelastic.ElasticSession(jgraphs.resnet18_graph(),
                                   jcore.make_pus(*chip_smoke.ELASTIC_FLEET))
    fleet = jcore.make_pus(*chip_smoke.ELASTIC_FLEET)
    for pu in chip_smoke.ELASTIC_FAILS:
        sess.fail(pu)
    sess.join(fleet[chip_smoke.ELASTIC_FAILS[0] - 1])
    assert rec["curve"] == [list(c) for c in sess.degradation_curve()]
    assert len(rec["curve"]) == 4
    ab = rec["absorb"]
    assert ab["only_replicas"] == [1, 2, 3, 9, 10, 11, 12]
    assert ab["failed_pu"] == 1 and ab["recovery"] == "replica-absorb"
    rsess = jelastic.ElasticSession(jgraphs.resnet8_graph(),
                                    jcore.make_pus(*chip_smoke.ABSORB_FLEET),
                                    algorithm="lblp-r")
    ev = rsess.fail(1)
    assert (ev.recovery, ev.rate, ev.latency) == (
        "replica-absorb", ab["rate"], ab["latency"])


def test_serving_phase_equals_reference():
    rec = chip_smoke.serving_plane()
    models = {"resnet8": jgraphs.resnet8_graph(),
              "resnet18": jgraphs.resnet18_graph()}
    trace = jserving.load_trace(jserving.dump_trace([
        jserving.TraceEvent("arrive", tenant="cam-0", model="resnet8",
                            slo=jserving.SLO(min_rate=300.0, max_latency=0.05)),
        jserving.TraceEvent("arrive", tenant="bulk-0", model="resnet18",
                            slo=jserving.SLO(min_rate=400.0), weight=2.0),
        jserving.TraceEvent("fail", pu_id=3)]))
    for engine in ("exact", "periodic"):
        plane = jserving.ServingControlPlane(
            jcore.make_pus(*chip_smoke.SERVING_FLEET), models, engine=engine)
        plane.play(trace)
        assert rec[engine]["sha256"] == hashlib.sha256(
            plane.audit_json().encode()).hexdigest()
        assert rec[engine]["decisions"] == [
            (d.index, d.event, d.action, d.reason) for d in plane.decisions]


def test_serving_phase_fails_on_unequal_audits(monkeypatch):
    from repro_torch.core import serving
    calls = iter(range(100))
    real = serving.ServingControlPlane.audit_json
    monkeypatch.setattr(serving.ServingControlPlane, "audit_json",
                        lambda self: real(self) + str(next(calls)))
    with pytest.raises(AssertionError, match="two audits"):
        chip_smoke.serving_plane()


def test_partition_phase_equals_reference():
    rec = chip_smoke.stage_partition()
    ref = jpp.partition(jget_config(chip_smoke.PARTITION_ARCH),
                        chip_smoke.PARTITION_STAGES)
    assert rec["boundaries"] == ref.boundaries == [0, 10, 18, 27]
    assert rec["imbalance"] == pytest.approx(ref.imbalance, rel=1e-12)


def test_yolo_phase_rehearsed_on_cpu():
    """Phase 5b with the CPU on both sides at 64x64: the gate passes with
    max |d| 0, and serving returns finite figures."""
    dev = torch.device("cpu")
    params, rec = chip_smoke.yolo_card_vs_cpu(dev, 64, 2)
    assert rec["raw_max_abs_d"] == 0.0 and rec["decoded_max_abs_d"] == 0.0
    assert rec["raw_max_abs"] > 0
    out = chip_smoke.yolo_serve(params, dev, 64, 2, 2, lambda: None)
    assert out["frames_per_s"] > 0 and len(out["latency_ms"]) == 2
    assert out["flops"] == 2 * 8_742_912_000.0 / 100


def test_yolo_gate_fails_on_a_wrong_card(monkeypatch):
    """The card-against-CPU gate is live: a forward that is off by 1% on
    the "card" side fails it."""
    from repro_torch.models.cnn import yolo
    real = yolo.forward
    calls = []

    def skewed(params, x, cfg=yolo.YOLOV8N, decode=True):
        out = real(params, x, cfg, decode)
        calls.append(1)
        if len(calls) <= 2:                     # the CPU side runs first
            return out
        return [o * 1.01 for o in out] if not decode else out * 1.01

    monkeypatch.setattr(yolo, "forward", skewed)
    with pytest.raises(AssertionError, match="raw outputs differ"):
        chip_smoke.yolo_card_vs_cpu(torch.device("cpu"), 64, 1)


def test_yolo_bound_at_full_size():
    b = chip_smoke.yolo_bound_ms(640, 16)
    assert b["flops"] == 16 * 8_742_912_000.0
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(16 * 8.742912e9 / 67e12 * 1e3)
    assert 2.0 < b["bound_ms"] < 2.2


def _yolo_params():
    from repro_torch.models.cnn import yolo
    return yolo.init(torch.Generator().manual_seed(0), device="cpu")


def test_yolo_served_phase_rehearsed_on_cpu():
    """Phase 5b's served request and its spread at 64x64 on the CPU, where
    the request is the programmed forward: every gate passes, nothing is
    captured, and the spread has no traced round."""
    dev = torch.device("cpu")
    params = _yolo_params()
    rec, request, xs = chip_smoke.yolo_graphed(params, dev, 64, 2, 2, 1,
                                               lambda: None)
    assert rec["decoded_equal"] == [True, True] and rec["max_abs_d"] == 0.0
    assert rec["raw_equal"] and rec["second_batch_equal"]
    assert not rec["graphed"] and rec["captures"] == [] == rec["capture_s"]
    assert rec["foreign_tree_refused"] and rec["cpu_params_refused"]
    out = chip_smoke.yolo_spread(params, request, xs, 2, False)
    for name in ("eager", "graphed"):
        r = out[name]
        assert r["wall_ms"]["n"] == r["enqueue_ms"]["n"] == 4
        assert len(r["round_medians_ms"]) == 2 and r["round_max_over_min"] >= 1
        assert r["frames_per_s"] > 0 and "traced_device_ms" not in r


def _graphed_stand_ins(monkeypatch, params, cls=None):
    """The served request as ``GraphedForward`` on the CPU: the CUDA graph
    machinery stood in for (a replay recomputes the static outputs), the
    card check passing ``params`` only."""
    from test_torch_yolo_deploy import _recompute, _StandInGraph, _StandInStream

    from repro_torch.models.cnn import yolo

    class Rerun(yolo.GraphedForward):
        def capture(self, params, x):
            c = super().capture(params, x)
            c.graph.rerun = _recompute(self, c)
            return c
    cls = cls(Rerun) if cls else Rerun
    for name, fn in (("CUDAGraph", _StandInGraph),
                     ("graph", lambda graph, stream=None: contextlib.nullcontext()),
                     ("Stream", lambda device=None: _StandInStream()),
                     ("current_stream", lambda device=None: _StandInStream()),
                     ("stream", lambda stream: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fn)
    real = yolo._card_of
    monkeypatch.setattr(yolo, "_card_of", lambda p: torch.device("cpu")
                        if p is params else real(p))
    monkeypatch.setattr(yolo, "request", lambda p, hw: cls(p, hw))


def test_yolo_served_phase_with_stand_in_graphs(monkeypatch):
    """The phase's graph gates on the CPU: one capture for the request
    shape, none for its repeats, one more for the second batch size."""
    params = _yolo_params()
    _graphed_stand_ins(monkeypatch, params)
    rec, _, _ = chip_smoke.yolo_graphed(params, torch.device("cpu"), 64, 2,
                                        2, 1, lambda: None)
    assert rec["graphed"] and rec["captures"] == [1, 1, 2]
    assert len(rec["capture_s"]) == 2 and all(rec["decoded_equal"])


def _skewed(base):
    """A graphed request whose second decoded output is one ulp off in one
    element."""
    class Skewed(base):
        calls = 0

        def __call__(self, params, x, decode=True):
            out = super().__call__(params, x, decode)
            Skewed.calls += 1
            if decode and Skewed.calls == 2:
                out.view(-1)[7] = torch.nextafter(out.view(-1)[7],
                                                  torch.tensor(math.inf))
            return out
    return Skewed


def _recapturing(base):
    class Recapturing(base):
        def capture(self, params, x):
            c = super().capture(params, x)
            self.graphs[object()] = c        # a new graph on every call
            return c
    return Recapturing


def _unrefusing(base):
    class Unrefusing(base):
        def __call__(self, params, x, decode=True):
            return super().__call__(self.params, x, decode)
    return Unrefusing


@pytest.mark.parametrize("fault", ["skewed", "captures", "foreign", "cpu"])
def test_yolo_served_phase_fails_when_it_should(fault, monkeypatch):
    """A graphed output one ulp off, a capture on every call, a foreign
    tree served and CPU parameters taken each fail the phase."""
    from repro_torch.models.cnn import yolo
    params = _yolo_params()
    cls = {"skewed": _skewed, "captures": _recapturing,
           "foreign": _unrefusing}.get(fault)
    _graphed_stand_ins(monkeypatch, params, cls)
    if fault == "cpu":
        monkeypatch.setattr(yolo, "_card_of", lambda p: torch.device("cpu"))
    match = {"skewed": "differs from yolo.forward", "captures": "graphs",
             "foreign": "not refused", "cpu": "not refused"}[fault]
    with pytest.raises(AssertionError, match=match):
        chip_smoke.yolo_graphed(params, torch.device("cpu"), 64, 2, 2, 1,
                                lambda: None)


# ---------------------------------------------------------------------------
# Phases 10-12 (T1-T3): LM training
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402

from repro_torch.configs import GLOBAL_WINDOW, Segment, ShapeSpec  # noqa: E402
from repro_torch.models.lm import model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the training rehearsals: their many small
    ops, with one thread per core in each of several test workers, slow
    the workers down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_layers():
    """The T1 cut at smoke width: one local and one global layer."""
    return dataclasses.replace(get_config("gemma3-1b").smoke(), segments=(
        Segment("attn", 2, window_pattern=(64, GLOBAL_WINDOW)),))


@pytest.mark.usefixtures("one_torch_thread")
def test_train_t1_rehearsed_on_cpu():
    rec = chip_smoke.train_card_vs_cpu(_two_layers(), CPU, 96)
    assert rec["loss_rel"] == 0.0 and rec["grad_norm_rel"] == 0.0
    assert rec["worst_grad_rel"] == 0.0 and len(rec["leaves"]) == 11
    assert all(r["param_max_d"] == 0.0 for r in rec["leaves"].values())
    assert rec["lr"] == pytest.approx(3e-4)


@pytest.mark.usefixtures("one_torch_thread")
def test_train_t1_fails_on_a_wrong_card(monkeypatch):
    """The gate is live: gradients 10% off on the "card" side (the second
    call) fail it."""
    real = model.loss_and_grads
    calls = []

    def skewed(cfg, params, batch):
        loss, grads = real(cfg, params, batch)
        calls.append(1)
        if len(calls) == 2:
            grads = tree_map(lambda g: g * 1.1, grads)
        return loss, grads

    monkeypatch.setattr(model, "loss_and_grads", skewed)
    with pytest.raises(AssertionError, match="beyond the limits"):
        chip_smoke.train_card_vs_cpu(_two_layers(), CPU, 32)


@pytest.mark.usefixtures("one_torch_thread")
def test_train_t2_rehearsed_on_cpu(monkeypatch):
    """T2's loop at smoke width: 4 slices a step, finite falling losses
    (lr 3e-3: at smoke width a bf16 parameter's ulp exceeds the default
    3e-4 step), and a closure that runs one more step."""
    real = model.loss_fn
    slices = []
    monkeypatch.setattr(model, "loss_fn",
                        lambda *a: slices.append(1) or real(*a))
    cfg = get_config("gemma3-1b").smoke()
    rec, step = chip_smoke.train_steps(
        cfg, CPU, ShapeSpec("t2", 512, 8, "train"), 2, 4,
        adamw.AdamWConfig(lr=3e-3, warmup_steps=1), lambda: None)
    assert len(slices) == 4 * 4 and len(rec["step_s"]) == 4
    assert rec["losses"][-1] < rec["losses"][0]
    assert step() > 0 and len(slices) == 5 * 4


def test_train_t2_bound():
    """6 N tokens for gemma3-1b at batch 8 x 4096: 1.98e14 FLOP, 0.20 s at
    the bf16 peak."""
    n = transformer.param_count(get_config("gemma3-1b"))
    assert 1.0e9 < n < 1.02e9
    flop = 6 * n * chip_smoke.T2_BATCH * chip_smoke.T2_SEQ
    assert flop == pytest.approx(1.98e14, rel=5e-3)
    assert flop / chip_smoke.BF16_FLOPS_PER_S == pytest.approx(0.20, rel=1e-2)
    assert chip_smoke.T2_BATCH // chip_smoke.T2_MICROBATCH == 4


@pytest.mark.usefixtures("one_torch_thread")
def test_train_t3_rehearsed_on_cpu(tmp_path):
    cfg = get_config("gemma3-1b").smoke()
    rec = chip_smoke.train_example(
        cfg, CPU, 24, 2, 64, 4,
        adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=24),
        tmp_path, lambda: None)
    assert rec["resumed_from"] == 12 and rec["steps"] == 24
    assert rec["last10"] < rec["first10"]
    assert rec["retries"] == [0, 0, 0] and rec["rollbacks"] == [0, 0, 0]
    assert rec["ckpt_step"] == 24 and rec["restore_s"] > 0 and rec["save_s"] > 0


@pytest.mark.usefixtures("one_torch_thread")
def test_train_t3_fails_on_a_retried_step(tmp_path, monkeypatch):
    """A step that raised once and passed on retry still fails T3: the
    loop's retry must not hide a failing device step."""
    real = model.make_train_step
    failed = []

    def flaky(*a, **k):
        step = real(*a, **k)

        def once(*args):
            if not failed:
                failed.append(1)
                raise RuntimeError("injected")
            return step(*args)
        return once

    monkeypatch.setattr(model, "make_train_step", flaky)
    with pytest.raises(AssertionError, match="1 retries"):
        chip_smoke.train_example(
            get_config("gemma3-1b").smoke(), CPU, 6, 2, 32, 2,
            adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6),
            tmp_path, lambda: None)


def test_train_t3_config_is_the_examples():
    """T3's copy of ``examples/train_lm.py``'s geometry equals the
    example's own config field by field."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", ROOT / "examples" / "train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    want = dataclasses.asdict(example.make_100m_config())
    got = dataclasses.asdict(chip_smoke.stablelm_100m())
    assert got == want


def test_kernel_classes_sum_every_row():
    rows = [{"name": "nvjet_tst_192x192", "ms": 2.0},
            {"name": "void at::native::cunn_SoftMaxForwardReg<float>", "ms": 1.0},
            {"name": "void at::native::direct_copy_kernel_cuda", "ms": 0.5},
            {"name": "void at::native::reduce_kernel<512, 1>", "ms": 0.25},
            {"name": "void at::native::AUnaryFunctor<float>", "ms": 0.125}]
    assert chip_smoke.kernel_classes(rows) == {
        "gemm": 2.0, "softmax": 1.0, "copy/cast": 0.5, "reduce": 0.25,
        "elementwise": 0.125}


# ---------------------------------------------------------------------------
# Phases 13-16: the other LM families
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke_configs(monkeypatch):
    """The registry's configs at smoke width, for the phases that look
    archs up by name."""
    from repro_torch import configs
    full = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda arch: full(arch).smoke())


@pytest.mark.usefixtures("one_torch_thread", "smoke_configs")
def test_families_card_vs_cpu_rehearsed_on_cpu():
    """Phase 13 at smoke width with the CPU on both sides: every family's
    cut runs, logits and routes agree exactly, tokens are compared."""
    out = chip_smoke.families_card_vs_cpu(CPU)
    assert sorted(out) == sorted(a for a, *_ in chip_smoke.FAMILY_CARD_VS_CPU)
    for arch, rec in out.items():
        assert rec["worst_rel"] == 0.0 and rec["tokens_compared"] >= 1, arch
    moe_rec = out["granite-moe-3b-a800m"]
    # 2 layers x (640 prompt + 8 decode tokens), all routes equal
    assert moe_rec["route_sets"] == 2 * (640 + chip_smoke.FAMILY_DECODE_STEPS)
    assert moe_rec["route_sets_differing"] == 0


def test_families_card_vs_cpu_cuts():
    """The cuts phase 13 runs: 2 layers (granite-moe, falcon-mamba,
    paligemma), one hybrid3 super-block and one rec layer
    (recurrentgemma), 2 encoder + 2 decoder layers (whisper)."""
    layers = {arch: chip_smoke.cut(get_config(arch), *ns, enc=enc)
              for arch, ns, enc, _, _ in chip_smoke.FAMILY_CARD_VS_CPU}
    assert layers["recurrentgemma-9b"].n_layers == 4
    assert [s.n for s in layers["whisper-small"].enc_segments] == [2]
    assert all(layers[a].n_layers == 2 for a in (
        "granite-moe-3b-a800m", "falcon-mamba-7b", "paligemma-3b",
        "whisper-small"))
    assert layers["granite-moe-3b-a800m"].d_model == 1536


def test_families_gate_fails_on_a_wrong_card(monkeypatch):
    """Logits 10% off on the "card" side (the second prefill) fail phase
    13's gate for a family with an encoder."""
    cfg = chip_smoke.cut(get_config("whisper-small").smoke(), 2, enc=(2,))
    extra = chip_smoke.family_inputs(cfg, 1, 30, torch.Generator().manual_seed(2))
    real = transformer.prefill
    calls = []

    def skewed(*a, **k):
        logits, cache = real(*a, **k)
        calls.append(1)
        return (logits * 1.1 if len(calls) == 2 else logits), cache

    monkeypatch.setattr(transformer, "prefill", skewed)
    with pytest.raises(AssertionError, match="card logits differ"):
        chip_smoke.lm_card_vs_cpu(cfg, CPU, 16, 2, extra)


def _route_call(match, side, logits):
    """One ``route`` call of an identity router: x's rows are the logits."""
    from repro_torch.models.lm import moe
    match.side(side)
    E = logits.shape[-1]
    p = moe.MoEParams(torch.eye(E), *(torch.zeros((E, E, 2)),) * 3)
    return match(p, logits[None], 2)


def test_route_match_follows_the_cpu_on_near_ties():
    """The card's call takes the CPU's experts (gates from its own logits)
    where its own top-2 differs from the CPU's by a near tie."""
    from repro_torch.models.lm import moe
    match = chip_smoke.RouteMatch(moe.route, moe._top_k)
    cpu = torch.tensor([[3.0, 2.0, 1.99, 0.0], [0.0, 1.0, 2.0, 3.0]])
    card = cpu.clone()
    card[0, 2] = 2.01                      # a near tie: 2 and 1.99 swap
    _, e_cpu = _route_call(match, "cpu", cpu)
    gates, e_card = _route_call(match, "card", card)
    assert torch.equal(e_card, e_cpu) and match.differ == 1 and match.total == 2
    assert torch.allclose(gates[0, 0], torch.softmax(torch.tensor([3.0, 2.0]), 0))


def test_route_match_fails_where_it_is_no_tie():
    """Where the card's own top-k differs from the CPU's by more than a near
    tie (a broken top-k on the card: here, the bottom 2), the gate fails."""
    from repro_torch.models.lm import moe
    match = chip_smoke.RouteMatch(moe.route, lambda x, k: moe._top_k(-x, k))
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
    _route_call(match, "cpu", logits)
    with pytest.raises(AssertionError, match="not a near tie"):
        _route_call(match, "card", logits)


@pytest.mark.usefixtures("one_torch_thread", "smoke_configs")
def test_families_train_rehearsed_on_cpu():
    """Phase 16 at smoke width with the CPU on both sides: granite-moe's
    dispatch backward and falcon-mamba's scan backward, equal; no kernel
    launched."""
    out = chip_smoke.families_train(CPU)
    assert sorted(out) == sorted(chip_smoke.T16_ARCHS)
    for arch, rec in out.items():
        assert rec["loss_rel"] == 0.0 and rec["worst_grad_rel"] == 0.0, arch
    assert out["granite-moe-3b-a800m"]["route_sets_differing"] == 0


def test_step_path_rehearsed_on_cpu(monkeypatch):
    """Phase 15's step-function path at smoke width on the CPU for whisper
    (encoder frames) and paligemma (prefix): the counting wrapper sees the
    encoder's non-causal and the decoder's causal attention calls (no
    kernel launches on the CPU, so the launch check is stubbed)."""
    monkeypatch.setattr(chip_smoke, "check_flash_counts", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cfg = get_config("whisper-small").smoke()
    _, rec = chip_smoke.step_path(cfg, CPU, 2, 8, 3, 20, 4, lambda: None)
    assert rec["flash_by_causal"] == {"True": 2, "False": 2}
    cfg = get_config("paligemma-3b").smoke()
    _, rec = chip_smoke.step_path(cfg, CPU, 2, 8, 3, 0, 2, lambda: None)
    assert rec["flash_by_causal"] == {"True": 2, "False": 0}
    assert rec["prefix"] == cfg.num_prefix_tokens


def _smoke_server():
    from repro_torch.runtime.serve_loop import Server
    cfg = get_config("granite-moe-3b-a800m").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    return cfg, Server(cfg, params, max_batch=2, s_max=32)


@pytest.mark.parametrize("fault_at", [None, 2])
def test_graph_against_plain_rehearsed_on_cpu(fault_at):
    """Phases 8, 14 and 15's graphed-against-plain comparison at smoke width
    on the CPU, where ``Server`` has no graph and both sides run the plain
    step: equal tokens and logits, 0 retries (1 each with the fault
    hook), the server's decode step and hook restored."""
    cfg, server = _smoke_server()
    decode = server.decode
    prompts = [torch.arange(1, 9), torch.arange(3, 8)]
    rec = chip_smoke.graph_against_plain(cfg, server, prompts, 5,
                                         lambda: None, fault_at=fault_at)
    retries = 0 if fault_at is None else 1
    assert rec["tokens_equal"] and rec["logits_equal"]
    assert rec["retries"] == [retries, retries] and rec["graphs"] == 0
    assert server.decode is decode and server.fault_hook is None


@pytest.mark.parametrize("fault", ["logits", "launch"])
def test_graph_against_plain_fails_when_it_should(fault, monkeypatch):
    """Plain logits off by more than ``GRAPH_LOGIT_TOL`` fail the
    comparison, and so does a kernel launch counted in a decode step."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import model
    cfg, server = _smoke_server()
    plain = model.make_decode_step(cfg)
    if fault == "logits":
        def shifted(params, tok, cache):
            logits, cache = plain(params, tok, cache)
            return logits + 1.0, cache
        monkeypatch.setattr(model, "make_decode_step", lambda cfg: shifted)
        match = "differs from the plain one"
    else:
        def launching(params, tok, cache):
            flash_attention.launches += 1
            return plain(params, tok, cache)
        server.decode = launching
        match = "a kernel launch counted"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.graph_against_plain(cfg, server, [torch.arange(1, 9)], 4,
                                       lambda: None)


class _StandInPrefillGraph:
    """A stand-in for ``GraphedPrefill`` on the CPU: it runs the plain
    step and keeps an entry a prompt shape (or, with ``recapture``, one at
    every capture, as a key that missed its cache would), each capture
    taking 0.5 s, with one set of static outputs a shape of outputs (or,
    with ``per_width``, one a prompt width, as a graph that kept each
    width's outputs would)."""

    def __init__(self, step, recapture=False, per_width=False):
        from repro_torch.runtime import serve_loop
        self.step, self.recapture, self.per_width = step, recapture, per_width
        self.graphs, self.outputs, self.capture_seconds = {}, {}, []
        self.key, self.pool = serve_loop.GraphedPrefill.key, (0, 7)

    def capture(self, params, batch):
        from repro_torch.runtime import serve_loop
        key = len(self.graphs) if self.recapture else self.key(batch)
        if key not in self.graphs:
            out = self.step(params, batch)
            shapes = (key if self.per_width else ()) + serve_loop._shapes(out)
            out = self.outputs.setdefault(shapes, out)
            self.graphs[key] = serve_loop._Prefill(
                None, {k: t.clone() for k, t in batch.items()}, out,
                ((0, {}),))
            self.capture_seconds.append(0.5)
        return self.graphs[key]

    def __call__(self, params, batch):
        self.capture(params, batch)
        return self.step(params, batch)


@pytest.fixture
def cpu_memory(monkeypatch):
    """``torch.cuda``'s memory figures stood in for on the CPU: the bytes
    allocated are ``alloc[0]()``, the driver's bytes in use 3 MiB more,
    and the one pool's segments 2 MiB."""
    alloc = [lambda: 0]
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: alloc[0]())
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 30, (1 << 30) + alloc[0]()
                                             + (3 << 20)))
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [
        {"segment_pool_id": (0, 7), "total_size": 2 << 20},
        {"segment_pool_id": (0, 0), "total_size": 1 << 20}])
    return alloc


def _prompts():
    return [torch.arange(1, 9), torch.arange(3, 8)]


def _prefill_check(cfg, server, max_new, captures=()):
    """The plain side first, then the graphed side held against it, as
    ``serve_counted`` runs them (2 flash launches a prefill: smoke depth)."""
    plain = chip_smoke.plain_prefills(cfg, server, _prompts(), max_new,
                                      lambda: None)
    return chip_smoke.prefill_graph_against_plain(
        cfg, server, _prompts(), max_new, lambda: None, 2, plain, captures)


def test_prefill_graph_against_plain_rehearsed_on_cpu():
    """Phases 8, 14 and 15's graphed-against-plain prefill comparison at
    smoke width on the CPU, where ``Server`` has no prefill graph and both
    sides run the plain step: equal tokens and outputs, 0 retries, nothing
    captured or traced, the server's prefill and graph restored."""
    cfg, server = _smoke_server()
    prefill = server.prefill
    rec = _prefill_check(cfg, server, 5)
    assert rec["tokens_equal"] and rec["outputs_equal"] and not rec["unequal"]
    assert rec["prefills"] == [1, 1] and rec["retries"] == [0, 0]
    assert rec["flash_launches"] == [0, 0] and rec["graphs"] == 0
    assert rec["plain_reproducible"] and rec["plain_run_to_run"] == []
    assert rec["captures"] == rec["capture_s"] == []
    assert "trace_graphed" not in rec and "trace_eager" not in rec
    assert server.prefill is prefill and server.prefill_graph is None


def test_prefill_graph_against_plain_records_each_capture(cpu_memory):
    """With a prefill graph (a stand-in on the CPU) that captured the batch's
    width before, through ``probe_prefill_captures``: no new capture, and
    each capture's record: its shape and seconds, allocated before and
    after, held against its static inputs' and outputs' bytes (the tokens;
    the logits and every cache leaf), whether its outputs were new, and
    the driver's bytes in use."""
    from repro_torch.runtime.serve_loop import Request
    from repro_torch.tree import tree_leaves
    cfg, server = _smoke_server()
    g = _StandInPrefillGraph(server.prefill)
    server.prefill_graph = server.prefill = g
    captures = chip_smoke.probe_prefill_captures(server)
    cpu_memory[0] = lambda: sum(
        t.nbytes for c in g.graphs.values()
        for t in [*c.batch.values(), *tree_leaves(c.out)])
    g.capture(server.params, {"tokens": server._pad_prompts(
        [Request(0, p) for p in _prompts()])})
    rec = _prefill_check(cfg, server, 5, captures)
    c, = g.graphs.values()
    static = sum(t.nbytes for t in tree_leaves(c.out))
    assert rec["graphs"] == 1 and rec["capture_s"] == [0.5]
    assert rec["captures"] == [{
        "shape": [2, 8], "seconds": 0.5, "allocated_before": 0,
        "allocated_after": static + 128, "held": static + 128,
        "driver_used_delta": static + 128, "static_input_bytes": 128,
        "static_output_bytes": static, "new_outputs": True}]
    assert rec["tokens_equal"] and rec["outputs_equal"]
    assert "pool_reserved" not in rec          # the CPU: no pool is read
    assert server.prefill is g and server.prefill_graph is g


@pytest.mark.parametrize("fault", ["tokens", "outputs", "captures"])
def test_prefill_graph_against_plain_fails_when_it_should(fault, monkeypatch):
    """Greedy tokens that differ fail the comparison; so do outputs that
    differ where the plain prefill is bit-reproducible (here by a uniform
    shift of the logits, which leaves every token as it was), and a prompt
    width captured again."""
    from repro_torch.models.lm import model
    cfg, server = _smoke_server()
    plain = model.make_prefill_step(cfg, s_max=server.s_max)
    if fault == "captures":
        g = _StandInPrefillGraph(plain, recapture=True)
        server.prefill_graph = server.prefill = g
        match = "captured again"
    else:
        sign, shift, match = ((-1.0, 0.0, "tokens differ") if fault == "tokens"
                              else (1.0, 1.0, "outputs differ"))

        def changed(params, batch):
            logits, cache = plain(params, batch)
            return sign * logits + shift, cache
        monkeypatch.setattr(model, "make_prefill_step",
                            lambda cfg, s_max: changed)
    with pytest.raises(AssertionError, match=match):
        _prefill_check(cfg, server, 4)


@pytest.mark.parametrize("step,passes", [(1e-4, True), (0.1, False)])
def test_prefill_outputs_within_tolerance_only_where_plain_varies(
        step, passes, monkeypatch):
    """A plain prefill whose logits move by ``step`` of their max |x| from
    one call to the next (a uniform shift: the tokens stay) is not
    bit-reproducible: the graphed outputs may then differ from it within
    ``GRAPH_LOGIT_TOL`` of that max, and no further."""
    from repro_torch.models.lm import model
    cfg, server = _smoke_server()
    plain, calls = model.make_prefill_step(cfg, s_max=server.s_max), []

    def varying(params, batch):
        logits, cache = plain(params, batch)
        calls.append(1)
        return logits + len(calls) * step * logits.abs().max(), cache
    monkeypatch.setattr(model, "make_prefill_step",
                        lambda cfg, s_max: varying)
    if passes:
        rec = _prefill_check(cfg, server, 4)
        assert not rec["plain_reproducible"] and rec["unequal"]
        assert rec["plain_run_to_run"][0][0] == "logits"
        assert all(r <= chip_smoke.GRAPH_LOGIT_TOL for *_, r in rec["unequal"])
    else:
        with pytest.raises(AssertionError, match="outputs differ"):
            _prefill_check(cfg, server, 4)


def test_prefill_spread_refuses_a_card_server_without_its_graph():
    """On the card a server without a prefill graph would time the plain
    step against itself: ``prefill_spread`` refuses it before it runs."""
    cfg, server = _smoke_server()
    server.device = torch.device("cuda", 0)
    with pytest.raises(AssertionError, match="no prefill graph"):
        chip_smoke.prefill_spread(cfg, server, 2, 12, 2, 2, lambda: None)


@pytest.mark.parametrize("per_width", [False, True])
def test_prefill_widths_memory_gate(per_width, cpu_memory):
    """Phases 8 and 14's further prompt widths, rehearsed with a stand-in
    graph on the CPU: widths that share one set of static outputs hold
    their static tokens alone and pass; a graph that kept each width's
    outputs makes new ones and holds them, and fails."""
    from repro_torch.tree import tree_leaves
    cfg, server = _smoke_server()
    g = _StandInPrefillGraph(server.prefill, per_width=per_width)
    server.prefill_graph = server.prefill = g
    g.capture(server.params, {"tokens": torch.zeros((2, 4), dtype=torch.long)})
    cpu_memory[0] = lambda: sum(
        t.nbytes for c in g.graphs.values() for t in c.batch.values()) + sum(
        t.nbytes for out in g.outputs.values() for t in tree_leaves(out))
    widths = (5, 9, 13)
    if per_width:
        with pytest.raises(AssertionError, match="3 more prompt widths"):
            chip_smoke.prefill_widths_memory(cfg, server, 2, widths,
                                             lambda: None)
        return
    rec = chip_smoke.prefill_widths_memory(cfg, server, 2, widths,
                                           lambda: None)
    assert rec["captured"] == 3 and rec["new_outputs"] == 0
    assert rec["held"] == sum(2 * w * 8 for w in widths)
    assert rec["static_input_bytes"] == 3 * 512
    assert rec["pool_reserved"] == [2 << 20, 2 << 20]
    assert rec["capture_s"] == [0.5] * 3


def test_prefill_spread_rehearsed_on_cpu():
    """Phases 8 and 14's eager-against-graphed prefill rounds at smoke
    width on the CPU (both sides plain; no traced call): n, round medians
    and enqueue for each path."""
    cfg, server = _smoke_server()
    out = chip_smoke.prefill_spread(cfg, server, 2, 12, 2, 2, lambda: None)
    assert out["logits_equal"] and (out["batch"], out["width"]) == (2, 12)
    for name in ("eager", "graphed"):
        assert out[name]["wall_ms"]["n"] == 4
        assert len(out[name]["round_medians_ms"]) == 2
        assert "enqueue_ms" in out[name] and "host_share" not in out[name]


def test_dryrun_ratios_against_the_fixture():
    """Phase 18's ratios: a port cell equal to the reference's own figures
    reads 1 on every ratio, the held peak is the reference's less its f32
    copies (or the arguments + outputs - aliased floor), and a kind only
    the port has is listed with the reference's 0."""
    import json
    from repro_torch.launch import dryrun
    ref = json.loads(chip_smoke.DRYRUN_REFERENCE.read_text())["cells"][
        "gemma3-1b__decode_32k"]
    mem, cost = ref["memory"], ref["cost"]
    held = max(mem["peak_estimate_bytes"] - mem["f32_copy_bytes"],
               mem["argument_bytes"] + mem["output_bytes"]
               - mem["alias_bytes"])
    art = {"memory": {"peak_estimate_bytes": held,
                      "argument_bytes": mem["argument_bytes"]},
           "cost": {"flops_per_device": cost["flops_per_device"],
                    "matmul_flops_per_device": cost["dot_flops_per_device"],
                    "collective_bytes_per_device": dict(
                        cost["collective_bytes_per_device"],
                        **{"reduce-scatter": 8.0})}}
    vs = dryrun.against_reference(art, ref)
    assert vs["peak_held"] == 1.0 and vs["argument_equal"]
    assert vs["peak"] == held / mem["peak_estimate_bytes"] < 1.0
    assert vs["flops"] == vs["matmul_flops"] == 1.0
    assert vs["collectives"]["reduce-scatter"] == (8.0, 0.0, 0.0, 0.0)
    for k, b in cost["collective_bytes_per_device"].items():
        assert vs["collectives"][k][:2] == (b, b)
        assert vs["collectives"][k][3] == \
            cost["collective_bytes_one_layer_base"][k]


def test_kernel_bench_check_fails_when_it_should():
    """The reference's cases in order, then the served port cases and the
    two path sums; a case not launched, unequal to its plain version, on
    another instance than its rule's (its timed raw launch too) or without
    a column fails it, as does a host-only run."""
    from benchmarks_torch import kernel_bench as kb
    port = kb.served_cases()
    good = {name: {"kernel_us": 1.0, "matches_plain": True, "launches": 3}
            for name in chip_smoke.BENCH_CASES}
    for name in good:
        if name.startswith("flash."):        # f32 at hd 128
            good[name]["instances"] = {"tensor_core_f32": 3}
    for case in port:
        rec = dict.fromkeys(chip_smoke.PORT_FIELDS + chip_smoke.INT8_FIELDS,
                            1.0)
        rec.update(matches_plain=True, launches=3,
                   instances={kb.rule_instance(case): 3},
                   raw_instance=kb.rule_instance(case))
        good[case.key] = rec
    for path in kb.PATH_SUMS:
        good[f"port.path.{path}"] = {"kernel_us": 1.0, "cold_us": 1.0,
                                     "bound_us": 1.0}
    assert chip_smoke.check_kernel_bench(good) is good
    for bad in ({"launches": 0}, {"matches_plain": False},
                {"instances": {"cuda_core": 3}},
                {"instances": {"tensor_core_f32": 2, "cuda_core": 1}}):
        case = dict(good, **{"flash.2x8x1024x128": dict(
            good["flash.2x8x1024x128"], **bad)})
        with pytest.raises(AssertionError, match="flash.2x8x1024x128"):
            chip_smoke.check_kernel_bench(case)
    granite, conv = port[0].key, port[4].key
    for key, bad in ((granite, {"instances": {"cuda_core": 3}}),
                     (granite, {"launches": 0}),
                     (conv, {"instances": {"gather_n32": 2, "cp_async_n32": 1}}),
                     (conv, {"matches_plain": False}),
                     (conv, {"raw_instance": "cp_async_n128"})):
        case = dict(good, **{key: dict(good[key], **bad)})
        with pytest.raises(AssertionError, match=key):
            chip_smoke.check_kernel_bench(case)
    for key, field in ((granite, "cold_us"), (conv, "graph_us")):
        case = dict(good, **{key: {k: v for k, v in good[key].items()
                                   if k != field}})
        with pytest.raises(AssertionError, match=field):
            chip_smoke.check_kernel_bench(case)
    case = dict(good, **{"port.path.granite_prefill": {"kernel_us": 1.0}})
    with pytest.raises(AssertionError, match="cold_us"):
        chip_smoke.check_kernel_bench(case)
    with pytest.raises(AssertionError, match="cases"):     # a host-only run
        chip_smoke.check_kernel_bench({k: good[k]
                                       for k in chip_smoke.BENCH_CASES[:4]})
    with pytest.raises(AssertionError, match="cases"):     # no port case
        chip_smoke.check_kernel_bench({k: good[k]
                                       for k in chip_smoke.BENCH_CASES})
    host = {name: {"plain_us": 1.0} for name in good}
    with pytest.raises(AssertionError):
        chip_smoke.check_kernel_bench(host)


def test_path_ms_is_a_path_sum_in_ms():
    """The ``kernels`` line's ms fields come from a kernel bench path sum
    (µs); a path with no library call has none."""
    total = {"kernel_us": 520.0, "plain_us": 14500.0, "library_us": None,
             "bound_us": 122.4, "bound": "bytes"}
    assert chip_smoke.path_ms(total) == {
        "ms": 0.52, "plain_ms": 14.5, "library_ms": None,
        "bound_ms": pytest.approx(0.1224), "bound_by": "bytes"}
    assert chip_smoke.path_ms(dict(total, library_us=4687.0))[
        "library_ms"] == pytest.approx(4.687)


# ---------------------------------------------------------------------------
# The time account and the background jobs
# ---------------------------------------------------------------------------

import inspect  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402


def test_every_phase_is_timed_exactly_once():
    """Every phase of the run (1-22 and 5b) sits in exactly one
    ``account.phase`` block of the script."""
    ids = re.findall(r'account\.phase\("([^"]+)"',
                     inspect.getsource(chip_smoke))
    want = [str(i) for i in range(1, 23)] + ["5b"]
    assert sorted(ids) == sorted(want)
    assert len(set(ids)) == len(ids)


def test_account_records_phases_and_joins(tmp_path):
    """A phase's wall, a job's own wall and the wait on it land in the
    record; the job's commands run in turn, each with no card visible, one
    thread, at nice 19."""
    account = chip_smoke.Account(time.perf_counter())
    probe = [sys.executable, "-c",
             "import os; print(os.environ['CUDA_VISIBLE_DEVICES'] or '-', "
             "os.environ['OMP_NUM_THREADS'], os.nice(0))"]
    job = chip_smoke.Job("stand-in", [probe, probe], tmp_path / "stand-in.log",
                         60)
    with account.phase("1", "a phase"):
        time.sleep(0.05)
        job.join(account)
    rec = account.record()
    assert (tmp_path / "stand-in.log").read_text().split() == \
        ["-", "1", "19"] * 2
    assert len(job.walls) == 2 and sum(job.walls) <= rec["background_s"][
        "stand-in"]
    assert rec["phase_s"]["1"] >= 0.05
    assert 0 < rec["background_s"]["stand-in"] < 60
    assert 0 <= rec["wait_s"]["stand-in"] <= rec["phase_s"]["1"]
    assert rec["total_s"] >= rec["phase_s"]["1"]


def test_background_job_exit_fails_at_its_join(tmp_path):
    """A command that exits nonzero fails the job at its join, naming its
    log, and no later command of the job runs."""
    job = chip_smoke.Job("stand-in",
                         [[sys.executable, "-c", "import sys; sys.exit(3)"],
                          [sys.executable, "-c", "print('ran')"]],
                         tmp_path / "stand-in.log", 60)
    with pytest.raises(AssertionError,
                       match=r"stand-in: exit 3 \(log in .*/stand-in\.log"):
        job.join(chip_smoke.Account(time.perf_counter()))
    assert len(job.walls) == 1
    assert "ran" not in (tmp_path / "stand-in.log").read_text()


def test_background_job_past_its_timeout_fails(tmp_path):
    """A job still running at its timeout fails its join and is killed
    with the processes it started; its later commands never run."""
    import os
    child = ("import subprocess, sys, time; p = subprocess.Popen([sys."
             "executable, '-c', 'import time; time.sleep(120)']); "
             "print(p.pid, flush=True); time.sleep(120)")
    job = chip_smoke.Job("stand-in",
                         [[sys.executable, "-c", child],
                          [sys.executable, "-c", "print('ran')"]],
                         tmp_path / "stand-in.log", 5.0)
    t = time.perf_counter()
    with pytest.raises(AssertionError, match="still running 5.0 s after its "
                                             "start, killed"):
        job.join(chip_smoke.Account(time.perf_counter()))
    assert time.perf_counter() - t < 30
    assert job.proc.returncode is not None and not job.waiter.is_alive()
    log = (tmp_path / "stand-in.log").read_text()
    assert "ran" not in log
    grandchild = int(log.split()[0])
    for _ in range(100):            # reaped by init once killed
        if not os.path.exists(f"/proc/{grandchild}") or open(
                f"/proc/{grandchild}/stat").read().split()[2] == "Z":
            break
        time.sleep(0.1)
    else:
        raise AssertionError("the job's child outlived its timeout")
