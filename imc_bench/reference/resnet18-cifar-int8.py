"""Plain PyTorch reference of the INT8 ResNet-CIFAR deployment.

Follows the semantics the port states (``repro_torch.models.quant`` and
``executor.run_int8``), written anew in NCHW with no kernel of the port:

* weights symmetric per output channel, ``s_w = max|w| / Q``;
* activations symmetric per tensor at every conv input, with the scale
  calibrated on a float forward of the calibration batch (f32, TF32 off);
  the fc scales its input by its own batch's ``max|x| / Q``;
* exact integer accumulation (float64 holds every ResNet-18 sum: at most
  127^2 * 9 * 256 < 2^53), then ``(acc * s_x) * s_w + b`` in f32;
* ReLU after conv1 and after each residual add, the global average pool
  summed in float64 and rounded once, logits from the fc.

``Q`` is 127 (INT8); the control computes all of it with ``Q = 7``
(INT4), the next precision below the configuration's.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from imc_bench.weights import Leaf
from imc_bench.work import ConvShape, conv_ops, same_pads

BIAS_STD = 0.1


def _blocks(cfg):
    """(stage, block, stride, cin, width, has_down) of every block."""
    cin = cfg["stem_width"]
    for si, (width, n) in enumerate(zip(cfg["stage_widths"],
                                        cfg["blocks_per_stage"])):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            yield si, bi, stride, cin, width, stride != 1 or cin != width
            cin = width


def _conv_leaf(k, cin, cout):
    return {"w": Leaf((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin))),
            "b": Leaf((cout,), BIAS_STD)}


def param_shapes(cfg) -> Dict:
    """The port's parameter tree (HWIO weights): ``stem``,
    ``stages[si][bi]{conv1, conv2, down}``, ``fc``; He-normal weights."""
    stages: List[list] = [[] for _ in cfg["stage_widths"]]
    for si, bi, stride, cin, width, down in _blocks(cfg):
        block = {"conv1": _conv_leaf(3, cin, width),
                 "conv2": _conv_leaf(3, width, width)}
        if down:
            block["down"] = _conv_leaf(1, cin, width)
        stages[si].append(block)
    last = cfg["stage_widths"][-1]
    return {"stem": _conv_leaf(3, 3, cfg["stem_width"]), "stages": stages,
            "fc": {"w": Leaf((last, cfg["num_classes"]), math.sqrt(2.0 / last)),
                   "b": Leaf((cfg["num_classes"],), BIAS_STD)}}


def conv_shapes(cfg, batch: int) -> List[ConvShape]:
    """Every conv of a request of ``batch`` frames, in the graph's order."""
    h, w = cfg["image_hw"]
    out = [(batch, h, w, 3, cfg["stem_width"], 3, 1, "SAME")]
    for si, bi, stride, cin, width, down in _blocks(cfg):
        out.append((batch, h, w, cin, width, 3, stride, "SAME"))
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
        out.append((batch, ho, wo, width, width, 3, 1, "SAME"))
        if down:
            out.append((batch, h, w, cin, width, 1, stride, "SAME"))
        h, w = ho, wo
    return out


def ops_per_frame(cfg) -> int:
    """2 MACs of every conv and of the fc, for one frame."""
    fc = 2 * cfg["stage_widths"][-1] * cfg["num_classes"]
    return sum(conv_ops(s) for s in conv_shapes(cfg, 1)) + fc


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _scale(amax: torch.Tensor, q: int) -> torch.Tensor:
    """``max(amax, 1e-8) / q`` as a true f32 quotient."""
    return torch.clamp_min(amax, 1e-8) / torch.full_like(amax, float(q))


def _quant(x: torch.Tensor, s: torch.Tensor, q: int) -> torch.Tensor:
    return torch.round(x / s).clamp(-q, q)


def _pad(x, k, stride, value=0.0):
    top, bottom, left, right = same_pads(x.shape[2], x.shape[3], k, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


class QConv(NamedTuple):
    qw: torch.Tensor         # OIHW, integer values in float64
    sw: torch.Tensor         # (1, O, 1, 1) f32
    b: torch.Tensor          # (1, O, 1, 1) f32
    sx: torch.Tensor         # () f32 calibrated input scale
    stride: int


class State(NamedTuple):
    q: int
    convs: Dict[str, QConv]
    fc: tuple                # (qw (K, N) float64, sw (N,), b (N,))


def _float_forward(params, x, cfg, record):
    """The f32 float model on NCHW ``x``; ``record(name, t)`` sees each
    conv's input."""
    def conv(p, t, stride, name):
        record(name, t)
        w = p["w"].permute(3, 2, 0, 1)
        return F.conv2d(_pad(t, w.shape[2], stride), w, stride=stride) \
            + p["b"].view(1, -1, 1, 1)
    h = torch.relu(conv(params["stem"], x, 1, "stem"))
    for si, bi, stride, _, _, down in _blocks(cfg):
        block = params["stages"][si][bi]
        tag = f"s{si}b{bi}"
        y = torch.relu(conv(block["conv1"], h, stride, f"{tag}.conv1"))
        y = conv(block["conv2"], y, 1, f"{tag}.conv2")
        identity = conv(block["down"], h, stride, f"{tag}.down") if down else h
        h = torch.relu(y + identity)


def prepare(cfg, params, calib: torch.Tensor, control: bool = False) -> State:
    """Quantize the float weights and calibrate each conv's input scale on
    ``calib`` (NHWC), at INT8, or at INT4 for the control."""
    q = 7 if control else 127
    amax: Dict[str, torch.Tensor] = {}
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            _float_forward(params, calib.permute(0, 3, 1, 2), cfg,
                           lambda name, t: amax.__setitem__(name, t.abs().amax()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    def qconv(p, name, stride):
        w = p["w"].permute(3, 2, 0, 1)
        sw = _scale(w.abs().amax(dim=(1, 2, 3)), q)
        qw = _quant(w, sw.view(-1, 1, 1, 1), q).double()
        return QConv(qw, sw.view(1, -1, 1, 1), p["b"].view(1, -1, 1, 1),
                     _scale(amax[name], q), stride)

    convs = {"stem": qconv(params["stem"], "stem", 1)}
    for si, bi, stride, _, _, down in _blocks(cfg):
        block, tag = params["stages"][si][bi], f"s{si}b{bi}"
        convs[f"{tag}.conv1"] = qconv(block["conv1"], f"{tag}.conv1", stride)
        convs[f"{tag}.conv2"] = qconv(block["conv2"], f"{tag}.conv2", 1)
        if down:
            convs[f"{tag}.down"] = qconv(block["down"], f"{tag}.down", stride)
    w = params["fc"]["w"]
    sw = _scale(w.abs().amax(dim=0), q)
    return State(q, convs, (_quant(w, sw, q).double(), sw, params["fc"]["b"]))


def _run_conv(c: QConv, x: torch.Tensor, q: int) -> torch.Tensor:
    qx = _quant(x, c.sx, q).double()
    k = c.qw.shape[2]
    acc = F.conv2d(_pad(qx, k, c.stride), c.qw, stride=c.stride)
    return (acc.float() * c.sx) * c.sw + c.b


def forward(cfg, state: State, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, classes) of NHWC frames ``x``."""
    q, convs = state.q, state.convs
    with torch.no_grad():
        h = torch.relu(_run_conv(convs["stem"], x.permute(0, 3, 1, 2), q))
        for si, bi, _, _, _, down in _blocks(cfg):
            tag = f"s{si}b{bi}"
            y = torch.relu(_run_conv(convs[f"{tag}.conv1"], h, q))
            y = _run_conv(convs[f"{tag}.conv2"], y, q)
            identity = _run_conv(convs[f"{tag}.down"], h, q) if down else h
            h = torch.relu(y + identity)
        pooled = h.double().mean(dim=(2, 3)).float()
        qw, sw, b = state.fc
        sx = _scale(pooled.abs().amax(), q)
        acc = _quant(pooled, sx, q).double() @ qw
        return (acc.float() * sx) * sw + b


def compare(out: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``logit_gap``: the largest |served - reference| logit of a request,
    over the reference's largest |logit| in it."""
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        return {"logit_gap": math.inf}
    return {"logit_gap": float((out.float() - want).abs().max()
                               / want.abs().max())}
