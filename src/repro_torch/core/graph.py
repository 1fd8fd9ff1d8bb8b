"""DAG intermediate representation for neural-network deployment graphs.

A CNN is a directed acyclic graph of *nodes* (fused operator groups, e.g.
``Conv+ReLU``) that is mapped onto processing units.  This is the port's
own copy of the part of ``repro.core.graph`` that the CNN graph builders
and the executor use: construction, queries, topological order and JSON
round-trip.  Replication, multi-tenant unions, longest paths and the
simulator cache hooks come with the port of the scheduler.

* Node ids are 1-based integers to match the paper's Table I convention.
* ``OpKind`` distinguishes the functional class of every node; the PU
  compatibility of a node is derived from its kind (conv/MVM -> IMC,
  everything else -> DPU), overridable per node (``Node.pu_type``).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class PUType(enum.Enum):
    """Processing-unit class of the hybrid IMC device (paper §III)."""

    IMC = "imc"
    DPU = "dpu"


class OpKind(enum.Enum):
    """Functional class of a graph node.

    ``CONV``/``MVM`` are the in-memory-computable kinds; the rest are
    digital ops served by DPUs (paper §IV).  Activations are fused into
    their producer conv/MVM.
    """

    CONV = "conv"
    MVM = "mvm"                 # fully-connected / matmul
    ADD = "add"
    MUL = "mul"
    POOL_MAX = "pool_max"
    POOL_AVG = "pool_avg"
    GLOBAL_POOL = "global_pool"
    CONCAT = "concat"
    SPLIT = "split"
    RESHAPE = "reshape"
    UPSAMPLE = "upsample"
    SOFTMAX = "softmax"
    ACT = "act"                 # standalone activation (not fused)
    INPUT = "input"
    OUTPUT = "output"
    # LM-tier kinds
    ATTENTION = "attention"
    MOE = "moe"
    RECURRENT = "recurrent"
    EMBED = "embed"
    NORM = "norm"


#: op kinds that the IMC PUs execute natively (weight-stationary MVM class).
IMC_KINDS = frozenset(
    {OpKind.CONV, OpKind.MVM, OpKind.ATTENTION, OpKind.MOE, OpKind.EMBED}
)

#: zero-cost structural kinds (graph glue; the IMCE runtime folds these).
FREE_KINDS = frozenset({OpKind.INPUT, OpKind.OUTPUT})


def default_pu_type(kind: OpKind) -> PUType:
    """Paper §IV: conv/MVM -> IMC, every other function -> DPU."""
    return PUType.IMC if kind in IMC_KINDS else PUType.DPU


@dataclass
class Node:
    """One deployable node of the network graph.

    node_id:      1-based unique id (paper Table I numbering).
    name:         human-readable name (e.g. ``s0b0.conv1``).
    kind:         functional class; determines PU compatibility.
    flops:        op count of the node (2 per MAC).
    weight_bytes: stationary INT8 parameter footprint.
    out_bytes:    INT8 activation bytes forwarded to consumers.
    out_elems:    number of output elements.
    pu_type:      PU class executing this node (derived from kind).
    fused_act:    activation fused into this node ("relu"/"silu"/None).
    meta:         free-form dict (shapes, parameter path, stride, ...).
    """

    node_id: int
    name: str
    kind: OpKind
    flops: float = 0.0
    weight_bytes: float = 0.0
    out_bytes: float = 0.0
    out_elems: float = 0.0
    pu_type: Optional[PUType] = None
    fused_act: Optional[str] = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.pu_type is None:
            self.pu_type = default_pu_type(self.kind)

    def is_free(self) -> bool:
        return self.kind in FREE_KINDS


class GraphError(ValueError):
    pass


class Graph:
    """A DNN deployment DAG."""

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: Dict[int, Node] = {}
        self._succ: Dict[int, List[int]] = {}
        self._pred: Dict[int, List[int]] = {}
        self._topo_cache: Optional[List[int]] = None

    # -- construction ----------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.node_id in self.nodes:
            raise GraphError(f"duplicate node id {node.node_id}")
        self.nodes[node.node_id] = node
        self._succ[node.node_id] = []
        self._pred[node.node_id] = []
        self._topo_cache = None
        return node

    def add(self, name: str, kind: OpKind, *, deps: Sequence[int] = (), **kw) -> Node:
        """Create a node with the next free id and wire its deps."""
        nid = (max(self.nodes) + 1) if self.nodes else 1
        node = self.add_node(Node(node_id=nid, name=name, kind=kind, **kw))
        for d in deps:
            self.add_edge(d, nid)
        return node

    def add_edge(self, src: int, dst: int) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise GraphError(f"edge ({src},{dst}) references unknown node")
        if dst not in self._succ[src]:
            self._succ[src].append(dst)
            self._pred[dst].append(src)
        self._topo_cache = None

    # -- queries ----------------------------------------------------------
    def successors(self, nid: int) -> List[int]:
        return list(self._succ[nid])

    def predecessors(self, nid: int) -> List[int]:
        return list(self._pred[nid])

    def edges(self) -> Iterable[Tuple[int, int]]:
        for s, ds in self._succ.items():
            for d in ds:
                yield (s, d)

    def sources(self) -> List[int]:
        return [n for n in self.nodes if not self._pred[n]]

    def sinks(self) -> List[int]:
        return [n for n in self.nodes if not self._succ[n]]

    def __len__(self) -> int:
        return len(self.nodes)

    def num_nodes(self, kind: Optional[OpKind] = None,
                  pu_type: Optional[PUType] = None) -> int:
        return sum(1 for n in self.nodes.values()
                   if (kind is None or n.kind == kind)
                   and (pu_type is None or n.pu_type == pu_type))

    def total_weight_bytes(self) -> float:
        return sum(n.weight_bytes for n in self.nodes.values())

    def topo_order(self) -> List[int]:
        """Kahn topological order (stable: ready set kept sorted by id)."""
        if self._topo_cache is not None:
            return list(self._topo_cache)
        indeg = {n: len(self._pred[n]) for n in self.nodes}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[int] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            inserted = False
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
                    inserted = True
            if inserted:
                ready.sort()
        if len(order) != len(self.nodes):
            raise GraphError("graph has a cycle")
        self._topo_cache = order
        return list(order)

    def validate(self) -> None:
        self.topo_order()  # raises on cycle
        for nid, node in self.nodes.items():
            if node.node_id != nid:
                raise GraphError(f"node key {nid} != node_id {node.node_id}")

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "nodes": [
                    {
                        "id": n.node_id,
                        "name": n.name,
                        "kind": n.kind.value,
                        "flops": n.flops,
                        "weight_bytes": n.weight_bytes,
                        "out_bytes": n.out_bytes,
                        "out_elems": n.out_elems,
                        "pu_type": n.pu_type.value,
                        "fused_act": n.fused_act,
                        "meta": n.meta,
                    }
                    for n in self.nodes.values()
                ],
                "edges": list(self.edges()),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "Graph":
        raw = json.loads(text)
        g = cls(raw["name"])
        for nd in raw["nodes"]:
            g.add_node(Node(
                node_id=nd["id"], name=nd["name"], kind=OpKind(nd["kind"]),
                flops=nd["flops"], weight_bytes=nd["weight_bytes"],
                out_bytes=nd["out_bytes"], out_elems=nd["out_elems"],
                pu_type=PUType(nd["pu_type"]), fused_act=nd.get("fused_act"),
                meta=nd.get("meta", {}),
            ))
        for s, d in raw["edges"]:
            g.add_edge(s, d)
        return g
