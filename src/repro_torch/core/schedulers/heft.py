"""HEFT and CPOP — related-work baselines (paper ref [12], Topcuoglu et al.).

These are *insertion-based list schedulers* that also produce node start
times; we keep only the node->PU mapping (the simulator re-derives timing
under the compute-and-forward pipeline model, for an apples-to-apples
comparison with the paper's algorithms).

HEFT: nodes ranked by upward rank (mean exec + max(comm + succ rank));
each node is placed on the PU minimizing its earliest finish time (EFT)
with insertion into idle gaps.

CPOP: critical-path nodes are pinned to the single PU minimizing the
total critical-path time; other nodes placed by EFT.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from ..cost import PUSpec
from ..graph import Graph, Node, PUType
from .base import Assignment, Scheduler, schedulable_nodes


class _EFTState:
    """Per-PU schedule state with gap insertion."""

    def __init__(self, pus: Sequence[PUSpec]) -> None:
        self.slots: Dict[int, List[Tuple[float, float]]] = {p.pu_id: [] for p in pus}

    def earliest_start(self, pid: int, ready: float, dur: float) -> float:
        """Earliest start >= ready on PU pid, allowing gap insertion."""
        slots = self.slots[pid]
        t = ready
        for (s, e) in slots:
            if t + dur <= s:
                return t
            t = max(t, e)
        return t

    def commit(self, pid: int, start: float, dur: float) -> None:
        slots = self.slots[pid]
        slots.append((start, start + dur))
        slots.sort()


class HEFTScheduler(Scheduler):
    name = "heft"

    def _mean_time(self, node: Node, pus: Sequence[PUSpec]) -> float:
        ts = [
            self.cm.time(node, p.pu_type, p.speed)
            for p in pus
            if not math.isinf(self.cm.time(node, p.pu_type, p.speed))
        ]
        return sum(ts) / len(ts) if ts else 0.0

    def _upward_ranks(self, g: Graph, pus: Sequence[PUSpec]) -> Dict[int, float]:
        rank: Dict[int, float] = {}
        for nid in reversed(g.topo_order()):
            node = g.nodes[nid]
            w = 0.0 if node.is_free() else self._mean_time(node, pus)
            best = 0.0
            for s in g.successors(nid):
                comm = self.cm.transfer(node, same_pu=False) / 2.0  # mean comm
                best = max(best, comm + rank[s])
            rank[nid] = w + best
        return rank

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        cm = self.cm
        rank = self._upward_ranks(g, pus)
        mapping: Dict[int, int] = {}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        finish: Dict[int, float] = {}
        state = _EFTState(pus)

        order = sorted(
            (n for n in schedulable_nodes(g)),
            key=lambda n: (-rank[n.node_id], n.node_id),
        )
        # free nodes finish at time 0 wherever needed
        for n in g.nodes.values():
            if n.is_free():
                finish[n.node_id] = 0.0

        # HEFT requires a topologically consistent order; upward rank
        # guarantees ancestors rank higher only with positive weights, so
        # enforce readiness explicitly.
        scheduled = set(finish)
        pending = list(order)
        while pending:
            node = next(
                p for p in pending
                if all(q in scheduled or q in finish for q in g.predecessors(p.node_id))
            )
            pending.remove(node)
            best = None
            for p in self._compatible(node, pus):
                if not self._fits(node, p, weights):
                    continue
                dur = cm.time(node, p.pu_type, p.speed)
                ready = 0.0
                for q in g.predecessors(node.node_id):
                    comm = cm.transfer(g.nodes[q], same_pu=(mapping.get(q) == p.pu_id))
                    ready = max(ready, finish[q] + comm)
                start = state.earliest_start(p.pu_id, ready, dur)
                eft = start + dur
                if best is None or eft < best[0]:
                    best = (eft, start, dur, p)
            if best is None:  # capacity waiver
                p = self._compatible(node, pus)[0]
                dur = cm.time(node, p.pu_type, p.speed)
                best = (dur, 0.0, dur, p)
            eft, start, dur, p = best
            mapping[node.node_id] = p.pu_id
            weights[p.pu_id] += node.weight_bytes
            finish[node.node_id] = eft
            state.commit(p.pu_id, start, dur)
            scheduled.add(node.node_id)

        return Assignment(mapping=mapping, pus=list(pus), algorithm=self.name)


class CPOPScheduler(HEFTScheduler):
    name = "cpop"

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        cm = self.cm
        # critical path by execution time (native PU)
        cp = set(g.longest_path(lambda n: cm.time(n)))
        # pin CP nodes per type to the fastest compatible PU for that type
        pin: Dict[PUType, int] = {}
        for t in (PUType.IMC, PUType.DPU):
            cands = [p for p in pus if p.pu_type == t]
            if cands:
                pin[t] = max(cands, key=lambda p: p.speed).pu_id

        base = super().schedule(g, pus)
        mapping = dict(base.mapping)
        for nid in cp:
            node = g.nodes[nid]
            if node.is_free():
                continue
            pid = pin.get(node.pu_type)
            if pid is not None:
                mapping[nid] = pid
        return Assignment(mapping=mapping, pus=list(pus), algorithm=self.name,
                          meta={"critical_path": sorted(cp)})
