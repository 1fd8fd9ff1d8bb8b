"""The plain reference against the port's CPU path at small sizes, and
the INT8 configuration's control (INT4) failing the limit."""

import json
from pathlib import Path

import pytest
import torch

from imc_bench import spec, weights

ROOT = Path(__file__).resolve().parents[2]


def _config(name, **change):
    cfg = json.loads((ROOT / "imc_bench" / "configs" / f"{name}.json").read_text())
    cfg.update(change)
    return (cfg, spec.load_module(ROOT / "imc_bench" / "configs" / f"{name}.py"),
            spec.load_module(ROOT / "imc_bench" / "reference" / f"{name}.py"))


def _gaps(cfg, port, ref, seed, batch, calib_frames, control=False):
    hw = tuple(cfg["image_hw"])
    params = weights.make(ref.param_shapes(cfg), torch.Generator().manual_seed(seed))
    calib = weights.frames(torch.Generator().manual_seed(seed + 1), 1,
                           calib_frames, hw)[0] if calib_frames else None
    x = weights.frames(torch.Generator().manual_seed(seed + 2), 1, batch, hw)[0]
    if control:
        out = ref.forward(cfg, ref.prepare(cfg, params, calib, True), x)
    else:
        out = port.request(cfg, params, calib)(params, x)
    return ref.compare(out, ref.forward(cfg, ref.prepare(cfg, params, calib), x))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_resnet_int8_port_within_the_limit_and_int4_control_outside(seed):
    cfg, port, ref = _config("resnet18-cifar-int8")
    limit = cfg["limits"]["logit_gap"]
    assert _gaps(cfg, port, ref, seed, 4, 32)["logit_gap"] <= limit
    assert _gaps(cfg, port, ref, seed, 4, 32, control=True)["logit_gap"] > limit


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_yolov8n_port_within_the_limits(hw):
    cfg, port, ref = _config("yolov8n-f32", image_hw=list(hw))
    gaps = _gaps(cfg, port, ref, 3, 2, 0)
    assert set(gaps) == set(cfg["limits"])
    assert all(gaps[k] <= cfg["limits"][k] for k in gaps), gaps


def test_a_wrong_shape_or_a_nan_reads_infinite():
    _, _, ref = _config("resnet18-cifar-int8")
    want = torch.ones(4, 10)
    assert ref.compare(torch.ones(2, 10), want)["logit_gap"] == float("inf")
    bad = want.clone()
    bad[1, 3] = float("nan")
    assert ref.compare(bad, want)["logit_gap"] == float("inf")


@pytest.mark.card
def test_yolov8n_tf32_control_fails_on_the_card(card):
    """At 128 x 128 and 2 frames on the card: the port within both limits,
    the reference with TF32 on outside one of them."""
    cfg, port, ref = _config("yolov8n-f32", image_hw=[128, 128])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa: E731
    params = weights.make(ref.param_shapes(cfg), g(3))
    x = weights.frames(g(5), 1, 2, (128, 128))[0]
    want = ref.forward(cfg, ref.prepare(cfg, params, None), x)
    got = ref.compare(port.request(cfg, params, None)(params, x), want)
    ctl = ref.compare(ref.forward(cfg, ref.prepare(cfg, params, None, True), x), want)
    limits = cfg["limits"]
    assert all(got[k] <= limits[k] for k in limits), got
    assert any(ctl[k] > limits[k] for k in limits), ctl
