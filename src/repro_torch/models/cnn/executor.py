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

The INT8 mode is two steps, as an IMC deployment programs its crossbars
once and then streams frames: :func:`program_int8` computes each
CONV/MVM node's fixed state (its quantized weight, bias and calibrated
activation scale, and on the card the conv weight in the kernel's packed
layout), and :func:`run_int8` streams a batch through the graph with it.
``execute(..., mode="int8")`` does both on every call, as the reference
quantizes on every call; the weights' quantization is deterministic, so
programming once gives the same bits.  :class:`GraphedExecute` programs
once and replays the request from a CUDA graph: the port's way to run
the same function on the card, where the per-node glue would otherwise
leave the host setting the pace.

Supported node kinds cover the ResNet graphs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.core.graph import Graph, OpKind

from .. import quant
from ...kernels import conv2d, counts, ops
from ...kernels.conv2d import imc_conv2d
from ...kernels.imc_mvm import imc_mvm
from ...spans import RequestSpans
from ...tree import tree_leaves
from . import layers as L


def _param_at(params, path):
    node = params
    for p in path:
        node = node[p]
    return node


class Int8Node(NamedTuple):
    """A CONV/MVM node's fixed INT8 state."""
    qw: quant.QTensor                 # per-output-channel INT8 weight
    bias: torch.Tensor
    x_scale: Optional[torch.Tensor]   # () f32 calibrated input scale, or None
    packed: Optional[torch.Tensor]    # conv on the card: ``pack_weight(qw.q)``


def _walk(g: Graph, x: torch.Tensor, conv: Callable, mvm: Callable):
    """Evaluate ``g`` on ``x``; ``conv(nid, node, inp)`` and ``mvm(nid,
    node, inp)`` compute the CONV and MVM nodes.  Returns the sink output."""
    env: Dict[int, torch.Tensor] = {}
    out = None
    for nid in g.topo_order():
        node = g.nodes[nid]
        ins = [env[p] for p in g.predecessors(nid)]
        if node.kind == OpKind.CONV:
            env[nid] = conv(nid, node, ins[0] if ins else x)
        elif node.kind == OpKind.MVM:
            env[nid] = mvm(nid, node, ins[0])
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


def program_int8(g: Graph, params: Dict,
                 act_scales: Optional[Dict[str, float]] = None
                 ) -> Dict[int, Int8Node]:
    """The deployment's fixed state, by node id, for each CONV/MVM node of
    ``g``: its weight quantized per output channel, its bias, its
    calibrated activation scale (``act_scales[node.name]`` as a () f32
    tensor on the parameters' device; None without one, and always for the
    fc node, which scales by its own batch) and, for a conv whose weight
    lies on a CUDA device, that weight packed for the kernel."""
    state: Dict[int, Int8Node] = {}
    for nid, node in g.nodes.items():
        if node.kind not in (OpKind.CONV, OpKind.MVM):
            continue
        p = _param_at(params, node.meta["param"])
        qw = quant.quantize_weight(p["w"])
        scale = packed = None
        if node.kind == OpKind.CONV:
            s = (act_scales or {}).get(node.name)
            if s is not None:
                scale = torch.full((), s, dtype=torch.float32,
                                   device=p["w"].device)
            if qw.q.device.type == "cuda":
                packed = conv2d.pack_weight(qw.q)
        state[nid] = Int8Node(qw, p["b"], scale, packed)
    return state


def run_int8(g: Graph, state: Dict[int, Int8Node],
             x: torch.Tensor) -> torch.Tensor:
    """Stream batch ``x`` (NHWC) through ``g`` with the state of
    :func:`program_int8`.  Returns the sink output."""
    def conv(nid, node, inp):
        st = state[nid]
        qx = quant.quantize_act(inp, st.x_scale)
        y = ops.quantized_conv2d(qx.q, st.qw.q, qx.scale, st.qw.scale,
                                 st.bias, stride=node.meta["stride"],
                                 padding=node.meta["padding"],
                                 packed=st.packed)
        return L.activate(y, node.meta.get("act"))

    def mvm(nid, node, inp):
        st = state[nid]
        qx = quant.quantize_act(inp)
        return ops.quantized_matmul(qx.q, st.qw.q, qx.scale, st.qw.scale,
                                    st.bias)
    return _walk(g, x, conv, mvm)


def execute(g: Graph, params: Dict, x: torch.Tensor, mode: str = "float",
            act_scales: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Run graph ``g`` on batch ``x`` (NHWC).  Returns the sink output."""
    if mode not in ("float", "int8"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "int8":
        return run_int8(g, program_int8(g, params, act_scales), x)

    def conv(nid, node, inp):
        return L.conv2d(_param_at(params, node.meta["param"]), inp,
                        stride=node.meta["stride"],
                        padding=node.meta["padding"],
                        act=node.meta.get("act"))

    def mvm(nid, node, inp):
        return L.dense(_param_at(params, node.meta["param"]), inp)
    return _walk(g, x, conv, mvm)


# ---------------------------------------------------------------------------
# the request as one captured program
# ---------------------------------------------------------------------------

_COUNTED = ((imc_conv2d, "launches_by_instance"),
            (imc_mvm, "launches_by_instance"))


def _launch_counts() -> tuple:
    """The INT8 wrappers' counts: (launches, launches by instance) of
    ``imc_conv2d`` and of ``imc_mvm``."""
    return counts.snapshot(_COUNTED)


_count_delta = counts.delta


def _add_counts(delta: tuple, sign: int) -> None:
    counts.add(_COUNTED, delta, sign)


def _card_of(params) -> torch.device:
    """The CUDA device the parameters lie on; ``ValueError`` off the card."""
    device = tree_leaves(params)[0].device
    if device.type != "cuda":
        raise ValueError(f"GraphedExecute: parameters on {device}; a CUDA "
                         f"graph needs them on the card (the CPU's path is "
                         f"execute)")
    return device


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor          # the static input the graph reads
    out: torch.Tensor        # the static logits the graph writes
    launches: tuple          # the wrappers' counts one replay adds


class GraphedExecute:
    """``execute(g, params, x, mode="int8", act_scales)`` on the card as a
    weight-stationary deployment: the weights programmed once
    (:func:`program_int8`) and each request replayed from a CUDA graph.

    One graph for each (shape, dtype) of the input, captured from
    :func:`run_int8` after a warm-up on a side stream, over a static copy of
    the input.  A call copies ``x`` into the static input, replays, and
    returns a copy of the static logits, so a caller may keep the outputs
    of several requests.  The results equal ``execute``'s on the card: the
    same kernels on the same inputs in the same order.  The graph holds
    the parameters it was programmed with, and a call with others is
    refused; parameters off the card are refused too (the CPU's path is
    ``execute``).  A capture or replay error raises.

    The wrappers' launch counts move where a kernel is launched, and a
    capture records launches without running them: the capture takes its
    counts back, and every replay adds them, so the counts keep saying how
    many launches ran.  ``spans`` (a :class:`repro_torch.spans.RequestSpans`)
    records each request: its id, its call's time on the host clock, the
    host seconds of its input copy, replay and output copy, and on every
    ``spans.sample_every``-th request its device span; and each capture's
    parts (the input's copy, the warm-up with its seconds in ``nvcc``, the
    recording).  ``capture_seconds`` holds each capture's host seconds,
    warm-up included, read from ``spans.captures``."""

    def __init__(self, g: Graph, params: Dict,
                 act_scales: Optional[Dict[str, float]] = None) -> None:
        device = _card_of(params)
        self.g = g
        self.params = params
        self.device = device
        self.state = program_int8(g, params, act_scales)
        self.graphs: Dict[tuple, _Captured] = {}
        self.spans = RequestSpans(self.device)

    @property
    def capture_seconds(self) -> List[float]:
        return self.spans.capture_seconds

    @staticmethod
    def key(x: torch.Tensor) -> tuple:
        return tuple(x.shape), x.dtype

    def capture(self, params, x: torch.Tensor) -> _Captured:
        """The graph of ``key(x)``, captured if it is new."""
        if params is not self.params:
            raise ValueError("GraphedExecute: called with parameters other "
                             "than those it was programmed with")
        key = self.key(x)
        if key in self.graphs:
            return self.graphs[key]
        dev = self.device
        with self.spans.capture(key) as parts:
            static_x = x.to(dev, copy=True)
            with parts.warmup():
                stream = torch.cuda.Stream(device=dev)
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    run_int8(self.g, self.state, static_x)      # it runs
            with parts.record():
                graph = torch.cuda.CUDAGraph()
                before = _launch_counts()
                with torch.cuda.graph(graph, stream=stream):
                    out = run_int8(self.g, self.state, static_x)
                launches = _count_delta(_launch_counts(), before)
                _add_counts(launches, -1)
                torch.cuda.current_stream(dev).wait_stream(stream)
                self.graphs[key] = _Captured(graph, static_x, out, launches)
        return self.graphs[key]

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        c = self.capture(params, x)

        def replay():
            c.graph.replay()
            _add_counts(c.launches, 1)
        return self.spans.request(c.x, x, replay, c.out.clone)


def int8_request(g: Graph, params: Dict,
                 act_scales: Optional[Dict[str, float]] = None) -> Callable:
    """The INT8 request as it is served, a function of (params, x): a
    :class:`GraphedExecute` where the parameters lie on the card,
    ``execute(..., mode="int8")`` where they do not."""
    if tree_leaves(params)[0].device.type == "cuda":
        return GraphedExecute(g, params, act_scales)
    return lambda p, x: execute(g, p, x, mode="int8", act_scales=act_scales)
