"""Deployment-graph builders for the ResNet workloads.

Counterpart of the ResNet part of ``repro.models.cnn.graphs``.  Each
builder mirrors the executable model one-to-one and emits a ``Graph``
whose nodes carry scheduling cost metadata and execution metadata
(``meta["param"]``, a path into the model's parameter tree, plus op
attributes) consumed by ``repro_torch.models.cnn.executor``.

Node numbering is topological and matches the paper's Table I ids for
ResNet18-CIFAR.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.graph import Graph, OpKind

from . import layers as L
from .resnet import RESNET8, RESNET18_CIFAR


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
