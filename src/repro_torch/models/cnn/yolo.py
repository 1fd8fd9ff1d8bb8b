"""Executable YOLOv8n (the paper's §V.C workload) in PyTorch.

Counterpart of ``repro.models.cnn.yolo``: the ultralytics YOLOv8n
topology at width 0.25 / depth 0.33 (backbone P1..P5 + SPPF, PAN neck,
decoupled Detect head with DFL decoding), 3,151,888 parameters, with the
reference's parameter tree (``b0`` .. ``n21``, the C2f ``m`` lists, the
``head.cv2``/``head.cv3`` lists of ``"0"``/``"1"``/``"2"`` branches), so
``weights.from_jax_params`` carries a reference tree over as it is.
Layouts are the reference's: NHWC activations, HWIO weights.  The model
runs in float; its convs go through ``layers.conv2d`` (``F.conv2d``), as
the reference's go through ``lax.conv``.  The deployment graph
(``graphs.build_yolov8n_graph``) mirrors the model at ONNX-node
granularity: 233 nodes, 63 of them convolutional.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import layers as L

# width-scaled channel plan for v8n
CH = {"p1": 16, "p2": 32, "p3": 64, "p4": 128, "p5": 256}
NC = 80              # COCO classes
REG_MAX = 16         # DFL bins
STRIDES = (8, 16, 32)

YOLOV8N = {
    "name": "yolov8n",
    "image_hw": (640, 640),
    "nc": NC,
    "reg_max": REG_MAX,
}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _bottleneck_init(gen, c, device):
    return {"cv1": L.conv_init(gen, 3, c, c, device),
            "cv2": L.conv_init(gen, 3, c, c, device)}


def _c2f_init(gen, cin, cout, n, device):
    c = cout // 2
    return {
        "cv1": L.conv_init(gen, 1, cin, cout, device),
        "m": [_bottleneck_init(gen, c, device) for _ in range(n)],
        "cv2": L.conv_init(gen, 1, (2 + n) * c, cout, device),
    }


def _sppf_init(gen, c, device):
    return {"cv1": L.conv_init(gen, 1, c, c // 2, device),
            "cv2": L.conv_init(gen, 1, 2 * c, c, device)}


def _detect_init(gen, chs: Tuple[int, ...], device):
    c2 = max(16, chs[0] // 4, 4 * REG_MAX)      # 64 for v8n
    c3 = max(chs[0], min(NC, 100))              # 80 for v8n
    head = {"cv2": [], "cv3": []}
    for c in chs:
        head["cv2"].append({
            "0": L.conv_init(gen, 3, c, c2, device),
            "1": L.conv_init(gen, 3, c2, c2, device),
            "2": L.conv_init(gen, 1, c2, 4 * REG_MAX, device),   # plain conv
        })
        head["cv3"].append({
            "0": L.conv_init(gen, 3, c, c3, device),
            "1": L.conv_init(gen, 3, c3, c3, device),
            "2": L.conv_init(gen, 1, c3, NC, device),            # plain conv
        })
    return head


def init(generator: torch.Generator, cfg: dict = YOLOV8N,
         device="cuda") -> Dict:
    """Parameter tree of the reference's structure.  Draws from
    ``generator`` on the generator's own device and moves the result to
    ``device``, so one CPU generator seed gives the same parameters on
    every device."""
    gen, d = generator, device
    p = {}
    p["b0"] = L.conv_init(gen, 3, 3, CH["p1"], d)
    p["b1"] = L.conv_init(gen, 3, CH["p1"], CH["p2"], d)
    p["b2"] = _c2f_init(gen, CH["p2"], CH["p2"], 1, d)
    p["b3"] = L.conv_init(gen, 3, CH["p2"], CH["p3"], d)
    p["b4"] = _c2f_init(gen, CH["p3"], CH["p3"], 2, d)
    p["b5"] = L.conv_init(gen, 3, CH["p3"], CH["p4"], d)
    p["b6"] = _c2f_init(gen, CH["p4"], CH["p4"], 2, d)
    p["b7"] = L.conv_init(gen, 3, CH["p4"], CH["p5"], d)
    p["b8"] = _c2f_init(gen, CH["p5"], CH["p5"], 1, d)
    p["b9"] = _sppf_init(gen, CH["p5"], d)
    # neck
    p["n12"] = _c2f_init(gen, CH["p4"] + CH["p5"], CH["p4"], 1, d)
    p["n15"] = _c2f_init(gen, CH["p3"] + CH["p4"], CH["p3"], 1, d)
    p["n16"] = L.conv_init(gen, 3, CH["p3"], CH["p3"], d)
    p["n18"] = _c2f_init(gen, CH["p3"] + CH["p4"], CH["p4"], 1, d)
    p["n19"] = L.conv_init(gen, 3, CH["p4"], CH["p4"], d)
    p["n21"] = _c2f_init(gen, CH["p4"] + CH["p5"], CH["p5"], 1, d)
    p["head"] = _detect_init(gen, (CH["p3"], CH["p4"], CH["p5"]), d)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _conv(p, x, stride=1, act="silu"):
    return L.conv2d(p, x, stride=stride, act=act)


def _c2f(p, x, shortcut: bool):
    y = _conv(p["cv1"], x)
    a, b = torch.split(y, y.shape[-1] // 2, dim=-1)
    chunks = [a, b]
    h = b
    for bn in p["m"]:
        out = _conv(bn["cv2"], _conv(bn["cv1"], h))
        h = h + out if shortcut else out
        chunks.append(h)
    return _conv(p["cv2"], torch.cat(chunks, dim=-1))


def _sppf(p, x):
    y = _conv(p["cv1"], x)
    p1 = L.max_pool(y, 5, stride=1, padding="SAME")
    p2 = L.max_pool(p1, 5, stride=1, padding="SAME")
    p3 = L.max_pool(p2, 5, stride=1, padding="SAME")
    return _conv(p["cv2"], torch.cat([y, p1, p2, p3], dim=-1))


def backbone_neck(params, x):
    """Returns the three scale features (P3, P4, P5)."""
    x = _conv(params["b0"], x, stride=2)
    x = _conv(params["b1"], x, stride=2)
    x = _c2f(params["b2"], x, shortcut=True)
    x = _conv(params["b3"], x, stride=2)
    p3 = _c2f(params["b4"], x, shortcut=True)
    x = _conv(params["b5"], p3, stride=2)
    p4 = _c2f(params["b6"], x, shortcut=True)
    x = _conv(params["b7"], p4, stride=2)
    x = _c2f(params["b8"], x, shortcut=True)
    p5 = _sppf(params["b9"], x)
    # PAN neck
    u1 = L.upsample_nearest(p5)
    n12 = _c2f(params["n12"], torch.cat([u1, p4], dim=-1), shortcut=False)
    u2 = L.upsample_nearest(n12)
    n15 = _c2f(params["n15"], torch.cat([u2, p3], dim=-1), shortcut=False)
    d1 = _conv(params["n16"], n15, stride=2)
    n18 = _c2f(params["n18"], torch.cat([d1, n12], dim=-1), shortcut=False)
    d2 = _conv(params["n19"], n18, stride=2)
    n21 = _c2f(params["n21"], torch.cat([d2, p5], dim=-1), shortcut=False)
    return n15, n18, n21


def _head_branch(branch, x):
    y = _conv(branch["0"], x)
    y = _conv(branch["1"], y)
    return L.conv2d(branch["2"], y, act=None)   # plain conv, no act


def forward(params, x: torch.Tensor, cfg: dict = YOLOV8N, decode: bool = True):
    """NHWC image -> (B, anchors, 4+NC) decoded predictions (or the raw
    per-scale outputs, a list of (B, H/s, W/s, 4*REG_MAX+NC), with
    ``decode=False``)."""
    feats = backbone_neck(params, x)
    raw = []
    for i, f in enumerate(feats):
        box = _head_branch(params["head"]["cv2"][i], f)
        cls = _head_branch(params["head"]["cv3"][i], f)
        raw.append(torch.cat([box, cls], dim=-1))
    if not decode:
        return raw

    # DFL decode + dist2bbox (the 24 post-processing ONNX nodes)
    b, dev = x.shape[0], x.device
    flat, anchors, strides = [], [], []
    for f, s in zip(raw, STRIDES):
        _, h, w, c = f.shape
        flat.append(f.reshape(b, h * w, c))
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        anchors.append(torch.stack([xs.reshape(-1) + 0.5,
                                    ys.reshape(-1) + 0.5], -1))
        strides.append(torch.full((h * w, 1), float(s), device=dev))
    z = torch.cat(flat, dim=1)
    anchor = torch.cat(anchors, dim=0)
    stride = torch.cat(strides, dim=0)
    box, cls = z[..., : 4 * REG_MAX], z[..., 4 * REG_MAX:]
    # DFL: softmax over bins, expectation via fixed conv [0..15]
    box = box.reshape(b, -1, 4, REG_MAX)
    box = L.softmax(box, axis=-1) @ torch.arange(REG_MAX, dtype=torch.float32,
                                                 device=dev)
    lt, rb = box[..., :2], box[..., 2:]
    x1y1 = anchor - lt
    x2y2 = anchor + rb
    cxy = (x1y1 + x2y2) / 2.0
    wh = x2y2 - x1y1
    bbox = torch.cat([cxy, wh], dim=-1) * stride
    return torch.cat([bbox, torch.sigmoid(cls)], dim=-1)


def num_params(cfg: dict = YOLOV8N) -> int:
    """Parameter count; the tree is built on the meta device, so nothing
    is allocated on the card."""
    return L.count_params(init(torch.Generator().manual_seed(0), cfg,
                              device="meta"))
