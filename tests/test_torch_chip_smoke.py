"""The card-free phases of ``chip_smoke.py`` rehearsed on the CPU: the
LM card-against-CPU gate, the YOLOv8n phase and the training phases
T1-T3 (smoke widths, T3 at a few steps) with the CPU on both sides, and
the placement phase (schedule and simulate the ResNet-18
graph the main path executes and the YOLOv8n graph; elastic sessions;
the serving control plane; the stage partitioner) against the
reference."""

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
