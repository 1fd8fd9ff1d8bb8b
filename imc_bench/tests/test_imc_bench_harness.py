"""The harness on the CPU, its look for a card skipped: a new configuration,
traffic mix and metric found by their files alone; the result's keys; and
faults planted under the timed path coming out as not correct."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from imc_bench import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]

TOY_CONFIG = {"image_hw": [4, 4], "tf32": False, "ops_per_frame": 480,
              "peak_ops_per_s": 1e12, "limits": {"out_gap": 1e-4}}
TOY_BUILDER = '''
def request(cfg, params, calib):
    return lambda p, x: x.reshape(x.shape[0], -1) @ p["w"]
'''
TOY_REFERENCE = '''
import torch
from imc_bench.weights import Leaf


def param_shapes(cfg):
    return {"w": Leaf((48, 5), 1.0)}


def prepare(cfg, params, calib, control=False):
    return params["w"].double()


def forward(cfg, state, x):
    return (x.reshape(x.shape[0], -1).double() @ state).float()


def compare(out, want):
    return {"out_gap": float((out - want).abs().max())}
'''
TOY_TRAFFIC = {"frames_per_request": 3, "in_flight": 2, "distinct_batches": 4,
               "warmup_requests": 2, "trace_requests": 5, "checked_requests": 4}
TOY_METRIC = '''
def read(run):
    return None if run.traced is None else run.traced.requests
'''


def _copy(tmp_path):
    shutil.copytree(ROOT / "imc_bench", tmp_path / "imc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path


def _add_cell(root, name, config, traffic, config_file=None):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if not any(c["name"] == config for c in bench["configs"]):
        bench["configs"].append({
            "name": config, "source": "https://example.org/test", "reduced": [],
            "file": config_file or f"imc_bench/configs/{config}.json",
            "why": "test"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_a_new_configuration_traffic_and_metric_by_file_alone(tmp_path):
    root = _copy(tmp_path)
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "imc_bench").rglob("*") if p.is_file()}
    base = root / "imc_bench"
    (base / "configs" / "toy-affine.json").write_text(json.dumps(TOY_CONFIG))
    (base / "configs" / "toy-affine.py").write_text(TOY_BUILDER)
    (base / "reference" / "toy-affine.py").write_text(TOY_REFERENCE)
    (base / "traffic" / "toy-mix.json").write_text(json.dumps(TOY_TRAFFIC))
    (base / "metrics" / "toy_requests_traced.py").write_text(TOY_METRIC)
    bench = _add_cell(root, "toy.mix", "toy-affine", "toy-mix")
    bench["per_layer"].append({"name": "toy_requests_traced", "unit": "requests",
                               "better": "lower", "source": "device_trace",
                               "layer": "toy", "moves": "frames_per_s",
                               "workloads": ["toy.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "imc_bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if k in after)

    r = bench_run.run_cell(root, "toy.mix", 2 ** 31 + 99, 0.2, False, "cpu")
    assert list(r) == RESULT_KEYS + ["checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert r["metrics"]["frames_per_s"]["unit"] == "frames/s"
    assert r["checks"]["out_gap"]["value"] <= 1e-4

    t = bench_run.run_cell(root, "toy.mix", 7, 0.1, True, "cpu")
    assert list(t) == RESULT_KEYS + ["breakdown", "checks"]
    assert t["metrics"] == {"toy_requests_traced": {"value": 5, "unit": "requests"}}
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(t)


def test_a_listed_metric_that_reads_nothing_fails_the_run(tmp_path):
    root = _copy(tmp_path)
    base = root / "imc_bench"
    (base / "configs" / "toy-affine.json").write_text(json.dumps(TOY_CONFIG))
    (base / "configs" / "toy-affine.py").write_text(TOY_BUILDER)
    (base / "reference" / "toy-affine.py").write_text(TOY_REFERENCE)
    (base / "traffic" / "toy-mix.json").write_text(json.dumps(TOY_TRAFFIC))
    bench = _add_cell(root, "toy.mix", "toy-affine", "toy-mix")
    for m in bench["per_layer"]:
        if m["name"] == "capture_s":   # the toy's request captures no graph
            m["workloads"].append("toy.mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert bench_run.run_cell(root, "toy.mix", 3, 0.1, False, "cpu")["correct"]
    with pytest.raises(RuntimeError, match="capture_s read nothing in toy.mix"):
        bench_run.run_cell(root, "toy.mix", 3, 0.1, True, "cpu")


def _altered(request):
    def call(p, x):
        y = request(p, x)
        y.view(-1)[y.numel() // 2] += 0.05 * float(y.abs().max())
        return y
    return call


def _half_left_out(request):
    def call(p, x):
        y = request(p, x)
        half = y.shape[0] // 2
        y[half:] = y[:half]
        return y
    return call


@pytest.fixture(scope="module")
def small_cells(tmp_path_factory):
    root = _copy(tmp_path_factory.mktemp("bench"))
    base = root / "imc_bench"
    (base / "traffic" / "test-b4.json").write_text(json.dumps(
        {"frames_per_request": 4, "in_flight": 2, "distinct_batches": 2,
         "warmup_requests": 1, "trace_requests": 2, "checked_requests": 8}))
    _add_cell(root, "resnet18-int8.b4", "resnet18-cifar-int8", "test-b4")
    yolo = json.loads((base / "configs" / "yolov8n-f32.json").read_text())
    yolo["image_hw"] = [64, 64]
    (base / "configs" / "yolov8n-small.json").write_text(json.dumps(yolo))
    for part in ("configs", "reference"):
        shutil.copy(base / part / "yolov8n-f32.py", base / part / "yolov8n-small.py")
    _add_cell(root, "yolov8n.b4", "yolov8n-small", "test-b4")
    return root


@pytest.mark.parametrize("cell", ["resnet18-int8.b4", "yolov8n.b4"])
@pytest.mark.parametrize("fault", [None, _altered, _half_left_out],
                         ids=["sound", "answer_altered", "half_batch_left_out"])
def test_planted_faults_are_not_correct(small_cells, cell, fault):
    torch.manual_seed(0)
    r = bench_run.run_cell(small_cells, cell, 11, 0.2, False, "cpu", wrap=fault)
    assert r["correct"] == (fault is None), r["checks"]
    assert all(c["value"] is not None for c in r["checks"].values())
    json.loads(json.dumps(r), parse_constant=pytest.fail)


def test_a_wrong_shape_prints_as_text(small_cells):
    r = bench_run.run_cell(small_cells, "resnet18-int8.b4", 12, 0.2, False, "cpu",
                           wrap=lambda req: lambda p, x: req(p, x)[:1])
    assert not r["correct"] and r["checks"]["logit_gap"]["value"] == "inf"
    json.loads(json.dumps(r), parse_constant=pytest.fail)
