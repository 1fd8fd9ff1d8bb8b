"""Deployment-graph builders for the paper's CNN workloads.

Counterpart of ``repro.models.cnn.graphs``.  Each builder mirrors the
executable model one-to-one and emits a ``Graph`` whose nodes carry
scheduling cost metadata and execution metadata (``meta["param"]``, a
path into the model's parameter tree, plus op attributes).  The ResNet
graphs are runnable programs of ``repro_torch.models.cnn.executor``; the
YOLOv8n graph, as in the reference, is scheduled and simulated only, and
``yolo.forward`` runs the model.  ``to_json`` of every graph is
byte-equal to the reference's.

Node numbering is topological and matches the paper's Table I ids for
ResNet18-CIFAR.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.graph import Graph, OpKind

from . import layers as L
from .resnet import RESNET8, RESNET18_CIFAR
from .yolo import CH, NC, REG_MAX, YOLOV8N


def _add_conv(g: Graph, name: str, deps: List[int], h: int, w: int, k: int,
              cin: int, cout: int, stride: int, act: Optional[str],
              param: tuple, padding: str = "SAME") -> Tuple[int, int, int]:
    cost = L.conv_cost(h, w, k, cin, cout, stride, padding)
    meta = dict(cost.pop("meta"))
    meta.update(param=param, stride=stride, act=act, padding=padding, k=k)
    n = g.add(name, OpKind.CONV, deps=deps, fused_act=act, meta=meta, **cost)
    ho, wo = meta["out_hw"]
    return n.node_id, ho, wo


def build_resnet_graph(cfg: dict) -> Graph:
    """Deployment DAG for either ResNet variant (compute nodes only, no
    INPUT/OUTPUT glue, as the paper counts them)."""
    g = Graph(cfg["name"])
    h, w = cfg["image_hw"]
    cin = 3

    nid, h, w = _add_conv(g, "stem", [], h, w, 3, cin, cfg["stem_width"], 1,
                          "relu", ("stem",))
    cin = cfg["stem_width"]
    prev = nid

    for si, (width, nblocks) in enumerate(
        zip(cfg["stage_widths"], cfg["blocks_per_stage"])
    ):
        for bi in range(nblocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            needs_down = stride != 1 or cin != width
            identity = prev
            c1, h1, w1 = _add_conv(
                g, f"s{si}b{bi}.conv1", [prev], h, w, 3, cin, width, stride,
                "relu", ("stages", si, bi, "conv1"))
            c2, h2, w2 = _add_conv(
                g, f"s{si}b{bi}.conv2", [c1], h1, w1, 3, width, width, 1,
                None, ("stages", si, bi, "conv2"))
            add_deps = [c2]
            if needs_down:
                d, _, _ = _add_conv(
                    g, f"s{si}b{bi}.down", [identity], h, w, 1, cin, width,
                    stride, None, ("stages", si, bi, "down"))
                add_deps.append(d)
            else:
                add_deps.append(identity)
            cost = L.elem_cost(h2 * w2 * width)
            meta = dict(cost.pop("meta"))
            meta.update(act="relu")
            add = g.add(f"s{si}b{bi}.add", OpKind.ADD, deps=add_deps,
                        fused_act="relu", meta=meta, **cost)
            prev, h, w, cin = add.node_id, h2, w2, width

    cost = L.elem_cost(cin)
    cost.pop("meta")
    gap = g.add("gap", OpKind.GLOBAL_POOL, deps=[prev], meta={}, **cost)
    fc_cost = L.dense_cost(cin, cfg["num_classes"])
    meta = dict(fc_cost.pop("meta"))
    meta.update(param=("fc",))
    g.add("fc", OpKind.MVM, deps=[gap.node_id], meta=meta, **fc_cost)
    g.validate()
    return g


def resnet8_graph() -> Graph:
    return build_resnet_graph(RESNET8)


def resnet18_graph() -> Graph:
    return build_resnet_graph(RESNET18_CIFAR)


#: Table I (paper): the 21 MVM/conv node ids of ResNet18-CIFAR.
TABLE1_IMC_NODE_IDS = frozenset(
    {1, 2, 3, 5, 6, 8, 9, 10, 12, 13, 15, 16, 17, 19, 20, 22, 23, 24, 26, 27, 30}
)


# ===========================================================================
# YOLOv8n — ONNX-granularity deployment graph (paper §V.C: 233 nodes,
# 63 convolutional, 57 followed by SiLU).
#
# At ONNX level a "Conv" ultralytics module is Conv + Sigmoid + Mul (SiLU
# is NOT fused in the exported graph the paper deploys — that is what
# makes the count 233); the DFL expectation is a fixed-weight 1x1 conv,
# modelled as an MVM node (the paper counts 63 *convolutional* nodes,
# excluding it).  The three detection scales are the paper's "3 parallel
# main branches".
# ===========================================================================


class _Emit:
    """Stateful helper emitting ONNX-level nodes with cost metadata."""

    def __init__(self, g: Graph):
        self.g = g

    def conv_module(self, name, dep, h, w, k, cin, cout, stride=1):
        """Conv + Sigmoid + Mul (SiLU) -> returns (mul_id, ho, wo)."""
        cid, ho, wo = _add_conv(self.g, f"{name}.conv", [dep] if dep else [],
                                h, w, k, cin, cout, stride, None,
                                param=(name,))
        n_el = ho * wo * cout
        sig = self._elem(f"{name}.sigmoid", OpKind.ACT, [cid], n_el)
        mul = self._elem(f"{name}.mul", OpKind.MUL, [cid, sig], n_el)
        return mul, ho, wo

    def plain_conv(self, name, dep, h, w, k, cin, cout, stride=1):
        cid, ho, wo = _add_conv(self.g, name, [dep], h, w, k, cin, cout,
                                stride, None, param=(name,))
        return cid, ho, wo

    def _elem(self, name, kind, deps, n_elems):
        cost = L.elem_cost(n_elems)
        cost.pop("meta")
        return self.g.add(name, kind, deps=deps, meta={}, **cost).node_id

    def elem(self, name, kind, deps, n_elems):
        return self._elem(name, kind, deps, n_elems)

    def c2f(self, name, dep, h, w, cin, cout, n, shortcut):
        c = cout // 2
        cv1, h, w = self.conv_module(f"{name}.cv1", dep, h, w, 1, cin, cout)
        split = self._elem(f"{name}.split", OpKind.SPLIT, [cv1], h * w * cout)
        chunks = [split, split]
        prev = split
        for i in range(n):
            m1, _, _ = self.conv_module(f"{name}.m{i}.cv1", prev, h, w, 3, c, c)
            m2, _, _ = self.conv_module(f"{name}.m{i}.cv2", m1, h, w, 3, c, c)
            if shortcut:
                prev = self._elem(f"{name}.m{i}.add", OpKind.ADD,
                                  [prev, m2], h * w * c)
            else:
                prev = m2
            chunks.append(prev)
        cat = self._elem(f"{name}.concat", OpKind.CONCAT, chunks,
                         h * w * (2 + n) * c)
        cv2, h, w = self.conv_module(f"{name}.cv2", cat, h, w, 1,
                                     (2 + n) * c, cout)
        return cv2, h, w

    def sppf(self, name, dep, h, w, c):
        cv1, h, w = self.conv_module(f"{name}.cv1", dep, h, w, 1, c, c // 2)
        n_el = h * w * (c // 2)
        p1 = self._elem(f"{name}.pool1", OpKind.POOL_MAX, [cv1], n_el)
        p2 = self._elem(f"{name}.pool2", OpKind.POOL_MAX, [p1], n_el)
        p3 = self._elem(f"{name}.pool3", OpKind.POOL_MAX, [p2], n_el)
        cat = self._elem(f"{name}.concat", OpKind.CONCAT, [cv1, p1, p2, p3],
                         h * w * 2 * c)
        cv2, h, w = self.conv_module(f"{name}.cv2", cat, h, w, 1, 2 * c, c)
        return cv2, h, w


def build_yolov8n_graph(cfg: dict = YOLOV8N) -> Graph:
    g = Graph(cfg["name"])
    e = _Emit(g)
    h, w = cfg["image_hw"]

    # ---- backbone -------------------------------------------------------
    b0, h, w = e.conv_module("b0", None, h, w, 3, 3, CH["p1"], 2)
    b1, h, w = e.conv_module("b1", b0, h, w, 3, CH["p1"], CH["p2"], 2)
    b2, h, w = e.c2f("b2", b1, h, w, CH["p2"], CH["p2"], 1, True)
    b3, h, w = e.conv_module("b3", b2, h, w, 3, CH["p2"], CH["p3"], 2)
    p3, h3, w3 = e.c2f("b4", b3, h, w, CH["p3"], CH["p3"], 2, True)
    b5, h, w = e.conv_module("b5", p3, h3, w3, 3, CH["p3"], CH["p4"], 2)
    p4, h4, w4 = e.c2f("b6", b5, h, w, CH["p4"], CH["p4"], 2, True)
    b7, h, w = e.conv_module("b7", p4, h4, w4, 3, CH["p4"], CH["p5"], 2)
    b8, h, w = e.c2f("b8", b7, h, w, CH["p5"], CH["p5"], 1, True)
    p5, h5, w5 = e.sppf("b9", b8, h, w, CH["p5"])

    # ---- neck (PAN) ------------------------------------------------------
    u1 = e.elem("n10.upsample", OpKind.UPSAMPLE, [p5], h4 * w4 * CH["p5"])
    c1 = e.elem("n11.concat", OpKind.CONCAT, [u1, p4],
                h4 * w4 * (CH["p4"] + CH["p5"]))
    n12, _, _ = e.c2f("n12", c1, h4, w4, CH["p4"] + CH["p5"], CH["p4"], 1, False)
    u2 = e.elem("n13.upsample", OpKind.UPSAMPLE, [n12], h3 * w3 * CH["p4"])
    c2 = e.elem("n14.concat", OpKind.CONCAT, [u2, p3],
                h3 * w3 * (CH["p3"] + CH["p4"]))
    n15, _, _ = e.c2f("n15", c2, h3, w3, CH["p3"] + CH["p4"], CH["p3"], 1, False)
    n16, _, _ = e.conv_module("n16", n15, h3, w3, 3, CH["p3"], CH["p3"], 2)
    c3 = e.elem("n17.concat", OpKind.CONCAT, [n16, n12],
                h4 * w4 * (CH["p3"] + CH["p4"]))
    n18, _, _ = e.c2f("n18", c3, h4, w4, CH["p3"] + CH["p4"], CH["p4"], 1, False)
    n19, _, _ = e.conv_module("n19", n18, h4, w4, 3, CH["p4"], CH["p4"], 2)
    c4 = e.elem("n20.concat", OpKind.CONCAT, [n19, p5],
                h5 * w5 * (CH["p4"] + CH["p5"]))
    n21, _, _ = e.c2f("n21", c4, h5, w5, CH["p4"] + CH["p5"], CH["p5"], 1, False)

    # ---- detect head: 3 scales, box (cv2) + cls (cv3) branches -----------
    feats = [(n15, h3, w3, CH["p3"]), (n18, h4, w4, CH["p4"]),
             (n21, h5, w5, CH["p5"])]
    c2_, c3_ = max(16, CH["p3"] // 4, 4 * REG_MAX), max(CH["p3"], min(NC, 100))
    scale_outs = []
    for i, (f, fh, fw, fc) in enumerate(feats):
        bx, _, _ = e.conv_module(f"head.cv2.{i}.0", f, fh, fw, 3, fc, c2_)
        bx, _, _ = e.conv_module(f"head.cv2.{i}.1", bx, fh, fw, 3, c2_, c2_)
        bx, _, _ = e.plain_conv(f"head.cv2.{i}.2", bx, fh, fw, 1, c2_,
                                4 * REG_MAX)
        cl, _, _ = e.conv_module(f"head.cv3.{i}.0", f, fh, fw, 3, fc, c3_)
        cl, _, _ = e.conv_module(f"head.cv3.{i}.1", cl, fh, fw, 3, c3_, c3_)
        cl, _, _ = e.plain_conv(f"head.cv3.{i}.2", cl, fh, fw, 1, c3_, NC)
        n_el = fh * fw * (4 * REG_MAX + NC)
        cat = e.elem(f"head.concat.{i}", OpKind.CONCAT, [bx, cl], n_el)
        rs = e.elem(f"head.reshape.{i}", OpKind.RESHAPE, [cat], n_el)
        scale_outs.append((rs, fh * fw))

    anchors = sum(a for _, a in scale_outs)          # 8400 at 640x640
    no = 4 * REG_MAX + NC
    zcat = e.elem("head.concat_scales", OpKind.CONCAT,
                  [nid for nid, _ in scale_outs], anchors * no)
    spl = e.elem("head.split_box_cls", OpKind.SPLIT, [zcat], anchors * no)

    # DFL: Reshape -> Transpose -> Softmax -> Conv(1x1 fixed) -> Reshape
    dfl_el = anchors * 4 * REG_MAX
    d1 = e.elem("dfl.reshape1", OpKind.RESHAPE, [spl], dfl_el)
    d2 = e.elem("dfl.transpose", OpKind.RESHAPE, [d1], dfl_el)
    d3 = e.elem("dfl.softmax", OpKind.SOFTMAX, [d2], dfl_el)
    dfl_cost = L.dense_cost(REG_MAX, 1)
    dfl_meta = dict(dfl_cost.pop("meta"))
    dfl_meta.update(param=None, n_vectors=anchors * 4)
    dfl_cost["flops"] = 2.0 * dfl_el
    dfl_cost["out_bytes"] = dfl_cost["out_elems"] = float(anchors * 4)
    d4 = g.add("dfl.conv", OpKind.MVM, deps=[d3], meta=dfl_meta,
               **dfl_cost).node_id
    d5 = e.elem("dfl.reshape2", OpKind.RESHAPE, [d4], anchors * 4)

    # dist2bbox: slices, subs/adds, concat, stride mul
    lt = e.elem("box.slice_lt", OpKind.SPLIT, [d5], anchors * 2)
    rb = e.elem("box.slice_rb", OpKind.SPLIT, [d5], anchors * 2)
    x1y1 = e.elem("box.sub_x1y1", OpKind.ADD, [lt], anchors * 2)
    x2y2 = e.elem("box.add_x2y2", OpKind.ADD, [rb], anchors * 2)
    csum = e.elem("box.add_center", OpKind.ADD, [x1y1, x2y2], anchors * 2)
    cdiv = e.elem("box.div_center", OpKind.MUL, [csum], anchors * 2)
    wh = e.elem("box.sub_wh", OpKind.ADD, [x1y1, x2y2], anchors * 2)
    bcat = e.elem("box.concat_xywh", OpKind.CONCAT, [cdiv, wh], anchors * 4)
    bmul = e.elem("box.mul_strides", OpKind.MUL, [bcat], anchors * 4)
    csig = e.elem("cls.sigmoid", OpKind.ACT, [spl], anchors * NC)
    e.elem("out.concat", OpKind.CONCAT, [bmul, csig], anchors * (4 + NC))

    g.validate()
    return g


def yolov8n_graph() -> Graph:
    return build_yolov8n_graph()
