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

Served on the card (``request``), the model is a weight-stationary
deployment, as ``executor.GraphedExecute`` serves the INT8 CNN:
``program`` lays out each conv's weight and the decode's constants once,
and ``GraphedForward`` replays each request from a CUDA graph captured
from ``forward_programmed``.  The CPU runs ``forward_programmed`` as it
is.  The reference does not jit ``forward``; the graph adds no feature.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from ...spans import RequestSpans
from ...tree import tree_leaves
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


def _programmed_conv(p, x, stride=1, act="silu"):
    return L.conv2d_oihw(p["w"], p["b"], x, stride=stride, act=act)


def _c2f(p, x, conv, shortcut: bool):
    y = conv(p["cv1"], x)
    a, b = torch.split(y, y.shape[-1] // 2, dim=-1)
    chunks = [a, b]
    h = b
    for bn in p["m"]:
        out = conv(bn["cv2"], conv(bn["cv1"], h))
        h = h + out if shortcut else out
        chunks.append(h)
    return conv(p["cv2"], torch.cat(chunks, dim=-1))


def _sppf(p, x, conv):
    y = conv(p["cv1"], x)
    p1 = L.max_pool(y, 5, stride=1, padding="SAME")
    p2 = L.max_pool(p1, 5, stride=1, padding="SAME")
    p3 = L.max_pool(p2, 5, stride=1, padding="SAME")
    return conv(p["cv2"], torch.cat([y, p1, p2, p3], dim=-1))


def backbone_neck(params, x, conv=_conv):
    """Returns the three scale features (P3, P4, P5).  ``conv`` runs a
    conv leaf of ``params`` (``_conv`` on the parameter tree,
    ``_programmed_conv`` on :func:`program`'s)."""
    x = conv(params["b0"], x, stride=2)
    x = conv(params["b1"], x, stride=2)
    x = _c2f(params["b2"], x, conv, shortcut=True)
    x = conv(params["b3"], x, stride=2)
    p3 = _c2f(params["b4"], x, conv, shortcut=True)
    x = conv(params["b5"], p3, stride=2)
    p4 = _c2f(params["b6"], x, conv, shortcut=True)
    x = conv(params["b7"], p4, stride=2)
    x = _c2f(params["b8"], x, conv, shortcut=True)
    p5 = _sppf(params["b9"], x, conv)
    # PAN neck
    u1 = L.upsample_nearest(p5)
    n12 = _c2f(params["n12"], torch.cat([u1, p4], dim=-1), conv, shortcut=False)
    u2 = L.upsample_nearest(n12)
    n15 = _c2f(params["n15"], torch.cat([u2, p3], dim=-1), conv, shortcut=False)
    d1 = conv(params["n16"], n15, stride=2)
    n18 = _c2f(params["n18"], torch.cat([d1, n12], dim=-1), conv, shortcut=False)
    d2 = conv(params["n19"], n18, stride=2)
    n21 = _c2f(params["n21"], torch.cat([d2, p5], dim=-1), conv, shortcut=False)
    return n15, n18, n21


def _head_branch(branch, x, conv):
    y = conv(branch["0"], x)
    y = conv(branch["1"], y)
    return conv(branch["2"], y, act=None)   # plain conv, no act


def _raw(params, x, conv):
    feats = backbone_neck(params, x, conv)
    raw = []
    for i, f in enumerate(feats):
        box = _head_branch(params["head"]["cv2"][i], f, conv)
        cls = _head_branch(params["head"]["cv3"][i], f, conv)
        raw.append(torch.cat([box, cls], dim=-1))
    return raw


class DecodeConstants(NamedTuple):
    """What the DFL decode reads besides the raw outputs: each anchor's
    centre (A, 2) and stride (A, 1), and the bins' values [0..15]."""
    anchor: torch.Tensor
    stride: torch.Tensor
    bins: torch.Tensor


def decode_constants(scale_hw, device) -> DecodeConstants:
    """The decode's constants for the raw outputs' (height, width) at each
    of ``STRIDES``."""
    anchors, strides = [], []
    for (h, w), s in zip(scale_hw, STRIDES):
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        anchors.append(torch.stack([xs.reshape(-1) + 0.5,
                                    ys.reshape(-1) + 0.5], -1))
        strides.append(torch.full((h * w, 1), float(s), device=device))
    return DecodeConstants(torch.cat(anchors, dim=0), torch.cat(strides, dim=0),
                           torch.arange(REG_MAX, dtype=torch.float32,
                                        device=device))


def scale_hw(image_hw) -> list:
    """The raw outputs' (height, width) for an image of ``image_hw``: five
    stride-2 SAME convs, the last three scales."""
    h, w = image_hw
    out = []
    for i in range(5):
        h, w = L.conv_out_hw(h, w, 3, 2, "SAME")
        if i >= 2:
            out.append((h, w))
    return out


def _decode(raw, c: DecodeConstants):
    """DFL decode + dist2bbox (the 24 post-processing ONNX nodes)."""
    b = raw[0].shape[0]
    z = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in raw], dim=1)
    box, cls = z[..., : 4 * REG_MAX], z[..., 4 * REG_MAX:]
    # DFL: softmax over bins, expectation via fixed conv [0..15]
    box = box.reshape(b, -1, 4, REG_MAX)
    box = L.softmax(box, axis=-1) @ c.bins
    lt, rb = box[..., :2], box[..., 2:]
    x1y1 = c.anchor - lt
    x2y2 = c.anchor + rb
    cxy = (x1y1 + x2y2) / 2.0
    wh = x2y2 - x1y1
    bbox = torch.cat([cxy, wh], dim=-1) * c.stride
    return torch.cat([bbox, torch.sigmoid(cls)], dim=-1)


def forward(params, x: torch.Tensor, cfg: dict = YOLOV8N, decode: bool = True):
    """NHWC image -> (B, anchors, 4+NC) decoded predictions (or the raw
    per-scale outputs, a list of (B, H/s, W/s, 4*REG_MAX+NC), with
    ``decode=False``)."""
    raw = _raw(params, x, _conv)
    if not decode:
        return raw
    return _decode(raw, decode_constants([f.shape[1:3] for f in raw], x.device))


# ---------------------------------------------------------------------------
# the request as a weight-stationary deployment
# ---------------------------------------------------------------------------

class Programmed(NamedTuple):
    """What one deployment of YOLOv8n holds fixed: the parameter tree's
    structure with each conv's weight laid out once (``L.oihw_weight``)
    beside its bias, and the decode's constants for ``image_hw``."""
    convs: Dict
    decode: DecodeConstants
    image_hw: Tuple[int, int]


def _program_convs(tree):
    if isinstance(tree, list):
        return [_program_convs(v) for v in tree]
    if "w" in tree:
        return {"w": L.oihw_weight(tree["w"]), "b": tree["b"]}
    return {k: _program_convs(v) for k, v in tree.items()}


def program(params, image_hw) -> Programmed:
    """Lay out, once, what depends only on the weights and the image size
    (height, width).  ``params`` is left as it is."""
    image_hw = tuple(image_hw)
    device = tree_leaves(params)[0].device
    return Programmed(_program_convs(params),
                      decode_constants(scale_hw(image_hw), device), image_hw)


def forward_programmed(state: Programmed, x: torch.Tensor, decode: bool = True):
    """``forward(params, x, decode=decode)`` over ``program(params,
    image_hw)``'s state: the same ops in the same order on the same
    values, less the per-call weight layouts and decode constants."""
    if tuple(x.shape[1:3]) != state.image_hw:
        raise ValueError(f"yolo: images of {tuple(x.shape[1:3])}, programmed "
                         f"for {state.image_hw}")
    raw = _raw(state.convs, x, _programmed_conv)
    return _decode(raw, state.decode) if decode else raw


def _card_of(params) -> torch.device:
    """The CUDA device the parameters lie on; ``ValueError`` off the card."""
    device = tree_leaves(params)[0].device
    if device.type != "cuda":
        raise ValueError(f"GraphedForward: parameters on {device}; a CUDA "
                         f"graph needs them on the card (the CPU's path is "
                         f"forward_programmed)")
    return device


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor          # the static input the graph reads
    raw: list                # the static raw outputs the graph writes
    out: torch.Tensor        # the static decoded output


class GraphedForward:
    """``forward(params, x, decode)`` on the card as a weight-stationary
    deployment: :func:`program` once, each request replayed from a CUDA
    graph.

    One graph for each (shape, dtype) of the input, captured from
    :func:`forward_programmed` (the raw outputs, then their decode) after
    a warm-up on a side stream, over a static copy of the input.  A call
    copies ``x`` into the static input, replays, and returns a copy of
    the static decoded (or raw) output, so a caller may keep the outputs
    of several requests.  The graph holds the parameters it was
    programmed with, and a call with others is refused; parameters off
    the card are refused too.  A capture or replay error raises.
    ``spans`` (a :class:`repro_torch.spans.RequestSpans`) records each
    request: its id, its call's time on the host clock, the host seconds of
    its input copy, replay and output copy, and on every
    ``spans.sample_every``-th request its device span; and each capture's
    parts (the input's copy, the warm-up, the recording).
    ``capture_seconds`` holds each capture's host seconds, warm-up
    included, read from ``spans.captures``."""

    def __init__(self, params, image_hw) -> None:
        self.device = _card_of(params)
        self.params = params
        self.state = program(params, image_hw)
        self.graphs: Dict[tuple, _Captured] = {}
        self.spans = RequestSpans(self.device)

    @property
    def capture_seconds(self) -> List[float]:
        return self.spans.capture_seconds

    def _run(self, x):
        raw = forward_programmed(self.state, x, decode=False)
        return raw, _decode(raw, self.state.decode)

    def capture(self, params, x: torch.Tensor) -> _Captured:
        """The graph of ``x``'s (shape, dtype), captured if it is new."""
        if params is not self.params:
            raise ValueError("GraphedForward: called with parameters other "
                             "than those it was programmed with")
        key = (tuple(x.shape), x.dtype)
        if key in self.graphs:
            return self.graphs[key]
        dev = self.device
        with self.spans.capture(key) as parts:
            static_x = x.to(dev, copy=True)
            with parts.warmup():
                stream = torch.cuda.Stream(device=dev)
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    self._run(static_x)                  # it runs
            with parts.record():
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=stream):
                    raw, out = self._run(static_x)
                torch.cuda.current_stream(dev).wait_stream(stream)
                self.graphs[key] = _Captured(graph, static_x, raw, out)
        return self.graphs[key]

    def __call__(self, params, x: torch.Tensor, decode: bool = True):
        c = self.capture(params, x)
        copy_out = c.out.clone if decode else (lambda: [r.clone() for r in c.raw])
        return self.spans.request(c.x, x, c.graph.replay, copy_out)


def request(params, image_hw):
    """The request as it is served, a function of (params, x, decode=True):
    a :class:`GraphedForward` where the parameters lie on the card,
    :func:`forward_programmed` over :func:`program`'s state where they do
    not."""
    if tree_leaves(params)[0].device.type == "cuda":
        return GraphedForward(params, image_hw)
    state = program(params, image_hw)

    def plain(p, x, decode=True):
        if p is not params:
            raise ValueError("yolo.request: called with parameters other "
                             "than those it was programmed with")
        return forward_programmed(state, x, decode)
    return plain


def num_params(cfg: dict = YOLOV8N) -> int:
    """Parameter count; the tree is built on the meta device, so nothing
    is allocated on the card."""
    return L.count_params(init(torch.Generator().manual_seed(0), cfg,
                              device="meta"))
