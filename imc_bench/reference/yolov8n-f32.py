"""Plain PyTorch reference of YOLOv8n (f32), decode included.

Follows the semantics the port states (``repro_torch.models.cnn.yolo``,
the ultralytics v8 topology at width 0.25, depth 0.33), written anew in
NCHW with no kernel and no code of the port:

* Conv = conv + bias + SiLU, SAME padding split floor/ceil (as XLA and
  the port pad, not ultralytics' symmetric padding);
* C2f (split in two, ``n`` bottlenecks of two 3x3 convs, the residual
  only in the backbone), SPPF (three chained 5x5 max pools), the PAN neck
  with nearest upsampling;
* the Detect head's box (4 x 16 DFL bins) and class (80) branches at
  strides 8, 16, 32, and the decode: softmax over the bins, their
  expectation, dist2bbox to (cx, cy, w, h) in pixels, sigmoid scores.

Computed in f32 with TF32 off, the configuration's precision; the control
computes it with TF32 on, the next precision below.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from imc_bench.weights import Leaf
from imc_bench.work import ConvShape, conv_ops, same_pads

BIAS_STD = 0.1


def _conv_leaf(k, cin, cout):
    return {"w": Leaf((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin))),
            "b": Leaf((cout,), BIAS_STD)}


class Net(NamedTuple):
    """Channel plan of the configuration."""
    p: Dict[str, int]        # p1..p5 widths
    nc: int
    reg_max: int


def _net(cfg) -> Net:
    return Net(dict(zip(("p1", "p2", "p3", "p4", "p5"), cfg["widths"])),
               cfg["nc"], cfg["reg_max"])


def _c2f_leaf(cin, cout, n):
    c = cout // 2
    return {"cv1": _conv_leaf(1, cin, cout),
            "m": [{"cv1": _conv_leaf(3, c, c), "cv2": _conv_leaf(3, c, c)}
                  for _ in range(n)],
            "cv2": _conv_leaf(1, (2 + n) * c, cout)}


def _head_widths(net: Net):
    p3 = net.p["p3"]
    return max(16, p3 // 4, 4 * net.reg_max), max(p3, min(net.nc, 100))


def param_shapes(cfg) -> Dict:
    """The port's parameter tree (``b0`` .. ``n21``, ``head.cv2/cv3``),
    HWIO weights, He-normal."""
    net = _net(cfg)
    p, (n1, n2) = net.p, cfg["c2f_depths"]
    c2, c3 = _head_widths(net)
    tree = {
        "b0": _conv_leaf(3, 3, p["p1"]), "b1": _conv_leaf(3, p["p1"], p["p2"]),
        "b2": _c2f_leaf(p["p2"], p["p2"], n1),
        "b3": _conv_leaf(3, p["p2"], p["p3"]),
        "b4": _c2f_leaf(p["p3"], p["p3"], n2),
        "b5": _conv_leaf(3, p["p3"], p["p4"]),
        "b6": _c2f_leaf(p["p4"], p["p4"], n2),
        "b7": _conv_leaf(3, p["p4"], p["p5"]),
        "b8": _c2f_leaf(p["p5"], p["p5"], n1),
        "b9": {"cv1": _conv_leaf(1, p["p5"], p["p5"] // 2),
               "cv2": _conv_leaf(1, 2 * p["p5"], p["p5"])},
        "n12": _c2f_leaf(p["p4"] + p["p5"], p["p4"], n1),
        "n15": _c2f_leaf(p["p3"] + p["p4"], p["p3"], n1),
        "n16": _conv_leaf(3, p["p3"], p["p3"]),
        "n18": _c2f_leaf(p["p3"] + p["p4"], p["p4"], n1),
        "n19": _conv_leaf(3, p["p4"], p["p4"]),
        "n21": _c2f_leaf(p["p4"] + p["p5"], p["p5"], n1),
    }
    chs = (p["p3"], p["p4"], p["p5"])
    tree["head"] = {
        "cv2": [{"0": _conv_leaf(3, c, c2), "1": _conv_leaf(3, c2, c2),
                 "2": _conv_leaf(1, c2, 4 * net.reg_max)} for c in chs],
        "cv3": [{"0": _conv_leaf(3, c, c3), "1": _conv_leaf(3, c3, c3),
                 "2": _conv_leaf(1, c3, net.nc)} for c in chs]}
    return tree


# ---------------------------------------------------------------------------
# the model, over a conv function: the reference's, or a shape recorder
# ---------------------------------------------------------------------------

def _c2f(p, x, conv, shortcut):
    y = conv(p["cv1"], x, 1, True)
    a, b = torch.chunk(y, 2, dim=1)
    chunks, h = [a, b], b
    for bn in p["m"]:
        out = conv(bn["cv2"], conv(bn["cv1"], h, 1, True), 1, True)
        h = h + out if shortcut else out
        chunks.append(h)
    return conv(p["cv2"], torch.cat(chunks, dim=1), 1, True)


def _pool5(x):
    return F.max_pool2d(F.pad(x, (2, 2, 2, 2), value=-math.inf), 5, 1)


def _raw(params, x, conv) -> List[torch.Tensor]:
    """The head's raw outputs (B, 4 * reg_max + nc, H, W) at strides 8, 16,
    32, from NCHW ``x``."""
    x = conv(params["b0"], x, 2, True)
    x = conv(params["b1"], x, 2, True)
    x = _c2f(params["b2"], x, conv, True)
    x = conv(params["b3"], x, 2, True)
    p3 = _c2f(params["b4"], x, conv, True)
    x = conv(params["b5"], p3, 2, True)
    p4 = _c2f(params["b6"], x, conv, True)
    x = conv(params["b7"], p4, 2, True)
    x = _c2f(params["b8"], x, conv, True)
    y = conv(params["b9"]["cv1"], x, 1, True)
    q1 = _pool5(y)
    q2 = _pool5(q1)
    p5 = conv(params["b9"]["cv2"], torch.cat([y, q1, q2, _pool5(q2)], 1), 1, True)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
    n12 = _c2f(params["n12"], torch.cat([up(p5), p4], 1), conv, False)
    n15 = _c2f(params["n15"], torch.cat([up(n12), p3], 1), conv, False)
    d1 = conv(params["n16"], n15, 2, True)
    n18 = _c2f(params["n18"], torch.cat([d1, n12], 1), conv, False)
    d2 = conv(params["n19"], n18, 2, True)
    n21 = _c2f(params["n21"], torch.cat([d2, p5], 1), conv, False)
    raw = []
    for i, f in enumerate((n15, n18, n21)):
        branch = []
        for side in ("cv2", "cv3"):
            br = params["head"][side][i]
            t = conv(br["0"], f, 1, True)
            t = conv(br["1"], t, 1, True)
            branch.append(conv(br["2"], t, 1, False))
        raw.append(torch.cat(branch, dim=1))
    return raw


def conv_shapes(cfg, batch: int) -> List[ConvShape]:
    """Every conv of a request of ``batch`` frames, in the model's order
    (the model run on the meta device, recording each conv's input)."""
    shapes: List[ConvShape] = []

    def record(p, x, stride, act):
        k, _, cin, cout = p["w"].shape
        B, _, H, W = x.shape
        shapes.append((B, H, W, cin, cout, k, stride, "SAME"))
        ho, wo = math.ceil(H / stride), math.ceil(W / stride)
        return torch.empty((B, cout, ho, wo), device="meta")
    shapes_tree = _meta_tree(param_shapes(cfg))
    _raw(shapes_tree, torch.empty((batch, 3, *cfg["image_hw"]), device="meta"),
         record)
    return shapes


def _meta_tree(tree):
    if isinstance(tree, Leaf):
        return torch.empty(tree.shape, device="meta")
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return [_meta_tree(v) for v in tree]


def anchors(cfg) -> int:
    h, w = cfg["image_hw"]
    return sum(math.ceil(h / s) * math.ceil(w / s) for s in cfg["strides"])


def ops_per_frame(cfg) -> int:
    """2 MACs of every conv, and of the DFL's fixed 1x1 conv over the bins
    (2 x anchors x 4 x reg_max), for one frame."""
    dfl = 2 * anchors(cfg) * 4 * cfg["reg_max"]
    return sum(conv_ops(s) for s in conv_shapes(cfg, 1)) + dfl


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

class State(NamedTuple):
    params: Dict             # OIHW weights, (1, C, 1, 1) biases
    tf32: bool
    reg_max: int
    strides: tuple


def _oihw(tree):
    if isinstance(tree, list):
        return [_oihw(v) for v in tree]
    if "w" in tree:
        return {"w": tree["w"].permute(3, 2, 0, 1).contiguous(),
                "b": tree["b"].view(1, -1, 1, 1)}
    return {k: _oihw(v) for k, v in tree.items()}


def prepare(cfg, params, calib, control: bool = False) -> State:
    """The weights in NCHW's layout; the control runs with TF32 on."""
    return State(_oihw(params), control, cfg["reg_max"], tuple(cfg["strides"]))


def _conv(p, x, stride, act):
    top, bottom, left, right = same_pads(x.shape[2], x.shape[3],
                                         p["w"].shape[2], stride)
    y = F.conv2d(F.pad(x, (left, right, top, bottom)), p["w"],
                 stride=stride) + p["b"]
    return F.silu(y) if act else y


def _decode(raw, reg_max, strides):
    b = raw[0].shape[0]
    z = torch.cat([r.flatten(2) for r in raw], dim=2).transpose(1, 2)
    dev = z.device
    bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
    dist = (torch.softmax(z[..., :4 * reg_max].reshape(b, -1, 4, reg_max),
                          dim=-1) * bins).sum(-1)
    centres, scale = [], []
    for r, s in zip(raw, strides):
        h, w = r.shape[2:]
        ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                torch.arange(w, device=dev, dtype=torch.float32),
                                indexing="ij")
        centres.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1) + 0.5)
        scale.append(torch.full((h * w, 1), float(s), device=dev))
    anchor, stride = torch.cat(centres), torch.cat(scale)
    x1y1, x2y2 = anchor - dist[..., :2], anchor + dist[..., 2:]
    box = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1) * stride
    return torch.cat([box, torch.sigmoid(z[..., 4 * reg_max:])], dim=-1)


def forward(cfg, state: State, x: torch.Tensor) -> torch.Tensor:
    """Decoded predictions (B, anchors, 4 + nc) of NHWC frames ``x``."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = state.tf32
    try:
        with torch.no_grad():
            raw = _raw(state.params, x.permute(0, 3, 1, 2), _conv)
            return _decode(raw, state.reg_max, state.strides)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def compare(out: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``box_gap``: the largest |served - reference| box coordinate of a
    request over the reference's largest |coordinate|; ``score_gap``: the
    largest |served - reference| class score (a probability)."""
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        return {"box_gap": math.inf, "score_gap": math.inf}
    d = (out.float() - want).abs()
    return {"box_gap": float(d[..., :4].max() / want[..., :4].abs().max()),
            "score_gap": float(d[..., 4:].max())}
