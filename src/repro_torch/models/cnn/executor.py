"""Graph executor: run a deployment ``Graph`` as a real program.

Counterpart of ``repro.models.cnn.executor``.  Numerics are
placement-invariant, so the executor walks the DAG in topological order
and evaluates each node, reading conv/fc parameters from the model's
parameter tree via ``node.meta["param"]`` paths.  It runs on the device
its inputs lie on.

* ``mode="float"`` — float32 reference through ``layers``.
* ``mode="int8"``  — per-node INT8 execution: activations are quantized
  per tensor at every conv/fc input (with the calibrated scale of
  ``act_scales[node.name]`` where given), weights per output channel, and
  the integer product with its requantization runs through
  ``repro_torch.kernels.ops``: the Hopper kernels for CUDA tensors, their
  plain versions for CPU tensors.  The results equal the reference's
  ``quant.quantized_conv2d``/``quantized_matmul``.  As in the reference,
  the fc node scales its input by its own batch and ignores
  ``act_scales``.

Supported node kinds cover the ResNet graphs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.graph import Graph, OpKind

from .. import quant
from ...kernels import ops
from . import layers as L


def _param_at(params, path):
    node = params
    for p in path:
        node = node[p]
    return node


def execute(g: Graph, params: Dict, x: torch.Tensor, mode: str = "float",
            act_scales: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Run graph ``g`` on batch ``x`` (NHWC).  Returns the sink output."""
    if mode not in ("float", "int8"):
        raise ValueError(f"unknown mode {mode!r}")
    env: Dict[int, torch.Tensor] = {}
    out = None
    for nid in g.topo_order():
        node = g.nodes[nid]
        ins = [env[p] for p in g.predecessors(nid)]
        if node.kind == OpKind.CONV:
            inp = ins[0] if ins else x
            p = _param_at(params, node.meta["param"])
            if mode == "int8":
                s = (act_scales or {}).get(node.name)
                qx = quant.quantize_act(inp, None if s is None else torch.full(
                    (), s, dtype=torch.float32, device=inp.device))
                qw = quant.quantize_weight(p["w"])
                y = ops.quantized_conv2d(qx.q, qw.q, qx.scale, qw.scale, p["b"],
                                         stride=node.meta["stride"],
                                         padding=node.meta["padding"])
                y = L.activate(y, node.meta.get("act"))
            else:
                y = L.conv2d(p, inp, stride=node.meta["stride"],
                             padding=node.meta["padding"],
                             act=node.meta.get("act"))
            env[nid] = y
        elif node.kind == OpKind.MVM:
            p = _param_at(params, node.meta["param"])
            if mode == "int8":
                qx = quant.quantize_act(ins[0])
                qw = quant.quantize_weight(p["w"])
                y = ops.quantized_matmul(qx.q, qw.q, qx.scale, qw.scale, p["b"])
            else:
                y = L.dense(p, ins[0])
            env[nid] = y
        elif node.kind == OpKind.ADD:
            env[nid] = L.activate(ins[0] + ins[1], node.meta.get("act"))
        elif node.kind == OpKind.GLOBAL_POOL:
            env[nid] = L.global_avg_pool(ins[0])
        elif node.kind == OpKind.INPUT:
            env[nid] = x
        elif node.kind == OpKind.OUTPUT:
            env[nid] = ins[0]
        else:
            raise NotImplementedError(
                f"executor does not implement {node.kind} (node {node.name}); "
                "ResNet-family graphs only")
        out = env[nid]
    return out
