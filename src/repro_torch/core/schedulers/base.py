"""Scheduler API: node-to-PU assignment production and validation.

A *schedule* here is purely the static mapping the paper studies
(``Assignment``: node_id -> pu_id).  Temporal behaviour (rate, latency,
utilization) is derived by ``repro_torch.core.simulator`` from the mapping.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from ..cost import CostModel, PUSpec
from ..graph import Graph, Node, PUType


class ScheduleError(ValueError):
    pass


@dataclass
class Assignment:
    """A node->PU mapping plus the context it was produced for."""

    mapping: Dict[int, int]                  # node_id -> pu_id
    pus: List[PUSpec]
    algorithm: str = "unknown"
    meta: dict = field(default_factory=dict)

    def pu_of(self, node_id: int) -> int:
        return self.mapping[node_id]

    def nodes_on(self, pu_id: int) -> List[int]:
        return sorted(n for n, p in self.mapping.items() if p == pu_id)

    def pu_by_id(self, pu_id: int) -> PUSpec:
        for p in self.pus:
            if p.pu_id == pu_id:
                return p
        raise KeyError(pu_id)

    def resolve_graph(self, g: Graph) -> Graph:
        """The graph this mapping actually refers to.

        Graph-transforming schedulers (lblp-r layer replication) map node
        ids of a derived graph stored in ``meta["replicated_graph"]``;
        when a caller passes the base graph, substitute the derived one so
        loads and validation see every mapped node."""
        rg = self.meta.get("replicated_graph")
        if rg is not None and any(nid not in g.nodes for nid in self.mapping):
            return rg
        return g

    # -- static per-PU aggregates ------------------------------------------
    def load(self, g: Graph, cm: CostModel) -> Dict[int, float]:
        """Per-frame assigned execution time per PU (the paper's load).

        Replicated nodes are amortized: a k-way replica serves every k-th
        frame, contributing ``time/k`` (``CostModel.frame_time``).  On an
        unreplicated graph this is exactly the paper's total-time load.
        """
        g = self.resolve_graph(g)
        out = {p.pu_id: 0.0 for p in self.pus}
        for nid, pid in self.mapping.items():
            pu = self.pu_by_id(pid)
            out[pid] += cm.frame_time(g.nodes[nid], pu.pu_type, pu.speed)
        return out

    def weights(self, g: Graph) -> Dict[int, float]:
        g = self.resolve_graph(g)
        out = {p.pu_id: 0.0 for p in self.pus}
        for nid, pid in self.mapping.items():
            out[pid] += g.nodes[nid].weight_bytes
        return out

    def bottleneck(self, g: Graph, cm: CostModel) -> float:
        """max per-PU load == steady-state pipeline interval (1/rate)."""
        return max(self.load(g, cm).values())

    # -- multi-tenant aggregates -------------------------------------------
    def tenant_load(self, g: Graph, cm: CostModel) -> Dict[str, Dict[int, float]]:
        """Per-tenant, per-PU assigned execution time.

        On a :class:`~repro_torch.core.graph.MultiTenantGraph` tenants come from
        the node tags; a plain single-model graph reports one tenant under
        its own name.  Summing over tenants recovers :meth:`load` exactly.
        """
        g = self.resolve_graph(g)
        out: Dict[str, Dict[int, float]] = {}
        for nid, pid in self.mapping.items():
            tenant = g.nodes[nid].meta.get("tenant", g.name)
            pu = self.pu_by_id(pid)
            per_pu = out.setdefault(tenant, {p.pu_id: 0.0 for p in self.pus})
            per_pu[pid] += cm.frame_time(g.nodes[nid], pu.pu_type, pu.speed)
        return out

    def tenant_bottleneck(self, g: Graph, cm: CostModel) -> Dict[str, float]:
        """Per-tenant max per-PU load: each tenant's own pipeline-interval
        lower bound if it ran alone on the fleet slice it was given."""
        return {t: max(per_pu.values())
                for t, per_pu in self.tenant_load(g, cm).items()}

    def validate(self, g: Graph, cm: CostModel,
                 check_capacity: bool = True) -> None:
        """Raise unless the mapping is executable on the fleet."""
        g = self.resolve_graph(g)
        unmapped = set(g.nodes) - set(self.mapping)
        unmapped = {n for n in unmapped if not g.nodes[n].is_free()}
        if unmapped:
            raise ScheduleError(f"unmapped nodes: {sorted(unmapped)}")
        for nid, pid in self.mapping.items():
            node = g.nodes[nid]
            pu = self.pu_by_id(pid)
            if math.isinf(cm.time(node, pu.pu_type, pu.speed)):
                raise ScheduleError(
                    f"node {nid} ({node.kind.value}) not executable on "
                    f"{pu.pu_type.value} PU {pid}"
                )
        if check_capacity:
            caps = {p.pu_id: p.capacity(cm.profile) for p in self.pus}
            for pid, w in self.weights(g).items():
                if w > caps[pid] * (1 + 1e-9):
                    raise ScheduleError(
                        f"PU {pid} weight capacity exceeded: {w:.0f} > {caps[pid]:.0f}"
                    )


class Scheduler:
    """Base class.  Subclasses implement :meth:`schedule`."""

    name = "base"

    def __init__(self, cost_model: Optional[CostModel] = None) -> None:
        self.cm = cost_model or CostModel()

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------------
    def _compatible(self, node: Node, pus: Sequence[PUSpec]) -> List[PUSpec]:
        """PUs that can execute ``node`` at finite cost, preferring the
        node's native type when any exist (paper's placement policy)."""
        native = [p for p in pus if p.pu_type == node.pu_type]
        if native:
            return native
        return [
            p for p in pus
            if not math.isinf(self.cm.time(node, p.pu_type, p.speed))
        ]

    def _fits(self, node: Node, pu: PUSpec, assigned_weights: Mapping[int, float]) -> bool:
        cap = pu.capacity(self.cm.profile)
        return assigned_weights.get(pu.pu_id, 0.0) + node.weight_bytes <= cap * (1 + 1e-9)

    def _assign_min_load(self, node: Node, candidates: Sequence[PUSpec],
                         mapping: Dict[int, int], load: Dict[int, float],
                         weights: Dict[int, float], spills: List[int],
                         conflicts=None,
                         on_pu: Optional[Dict[int, List[int]]] = None) -> None:
        """Min-load greedy placement with the LBLP capacity-waiver contract:
        a node no PU can hold is still assigned (the emulator spills its
        weights to DRAM) and recorded in ``spills``.  ``conflicts(a, b)``
        optionally marks node pairs to keep on different PUs when possible
        (the parallel-branch constraint; callers scope the predicate).
        ``on_pu`` (pu_id -> assigned node ids, maintained here) makes the
        conflict scan per candidate PU proportional to that PU's own
        nodes instead of the whole mapping; callers that pass it must
        start from a dict consistent with ``mapping``."""
        pool = [p for p in candidates if self._fits(node, p, weights)]
        if not pool:
            pool = list(candidates)  # capacity waiver (spill)
            spills.append(node.node_id)
        if conflicts is not None:
            nid = node.node_id
            if on_pu is not None:
                free = [
                    p for p in pool
                    if not any(conflicts(nid, other)
                               for other in on_pu.get(p.pu_id, ()))
                ]
            else:
                free = [
                    p for p in pool
                    if not any(
                        conflicts(nid, other)
                        for other, pid in mapping.items()
                        if pid == p.pu_id
                    )
                ]
            if free:
                pool = free
        best = min(pool, key=lambda p: (load[p.pu_id], p.pu_id))
        mapping[node.node_id] = best.pu_id
        if on_pu is not None:
            on_pu.setdefault(best.pu_id, []).append(node.node_id)
        # replicas are amortized (frame_time == time on unreplicated graphs)
        load[best.pu_id] += self.cm.frame_time(node, best.pu_type, best.speed)
        weights[best.pu_id] += node.weight_bytes


def split_fleet(pus: Sequence[PUSpec]) -> Dict[PUType, List[PUSpec]]:
    out: Dict[PUType, List[PUSpec]] = {PUType.IMC: [], PUType.DPU: []}
    for p in pus:
        out[p.pu_type].append(p)
    return out


def schedulable_nodes(g: Graph) -> List[Node]:
    """All nodes that need a PU (drops free INPUT/OUTPUT glue)."""
    return [n for n in g.nodes.values() if not n.is_free()]
