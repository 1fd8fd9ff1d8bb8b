"""LBLP-X — beyond-paper improved variant of LBLP.

Three additions over the paper's Algorithm 1:

1. **Criticality tie-break.**  When several PUs share the minimum load,
   prefer the PU whose last-assigned node is *not* a graph neighbour of
   the candidate (reduces serialization of dependent chains on one PU).
2. **Communication-aware placement.**  The greedy key becomes
   ``load + lambda * cross_edge_time`` where ``cross_edge_time`` is the
   added DRAM/IPI transfer cost the placement would introduce on edges to
   already-placed neighbours.  ``lambda`` defaults to 1 (transfer seconds
   weigh like compute seconds on the pipeline's critical path).
3. **Local-search refinement.**  After the greedy pass, first-improvement
   swap/move search over node pairs, accepting changes that reduce the
   vector (bottleneck_load, simulated_latency) lexicographically; budget
   bounded.

On the paper's CNNs this closes most of the gap between LBLP and the
branch-and-bound optimum (see benchmarks/scheduler_quality.py).
"""

from __future__ import annotations

from typing import Dict, Sequence

from ..cost import PUSpec
from ..graph import Graph, Node, PUType
from .base import Assignment, Scheduler, schedulable_nodes
from .lblp import LBLPScheduler


class LBLPXScheduler(Scheduler):
    name = "lblp-x"

    def __init__(self, cost_model=None, comm_lambda: float = 1.0,
                 refine_budget: int = 4000) -> None:
        super().__init__(cost_model)
        self.comm_lambda = comm_lambda
        self.refine_budget = refine_budget

    # -- phase 1: comm-aware greedy (LBLP ordering) ------------------------
    def _greedy(self, g: Graph, pus: Sequence[PUSpec]) -> Dict[int, int]:
        cm = self.cm
        mapping: Dict[int, int] = {}
        load: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}

        lp = g.longest_path(lambda n: cm.time(n))
        lp_set = set(lp)

        def comm_penalty(node: Node, pid: int) -> float:
            t = 0.0
            for q in g.predecessors(node.node_id):
                if q in mapping and mapping[q] != pid:
                    t += cm.transfer(g.nodes[q], same_pu=False)
            for s in g.successors(node.node_id):
                if s in mapping and mapping[s] != pid:
                    t += cm.transfer(node, same_pu=False)
            return t

        def has_parallel(node: Node, pid: int) -> bool:
            return any(g.is_parallel(node.node_id, o)
                       for o, q in mapping.items() if q == pid)

        def assign(node: Node) -> None:
            cands = self._compatible(node, pus)
            pool = [p for p in cands if self._fits(node, p, weights)] or cands
            # Unlike paper-LBLP's hard branch filter, branch separation is
            # only a tie-break here: load balance is never sacrificed.
            best = min(
                pool,
                key=lambda p: (
                    load[p.pu_id] + self.comm_lambda * comm_penalty(node, p.pu_id),
                    has_parallel(node, p.pu_id),
                    p.pu_id,
                ),
            )
            mapping[node.node_id] = best.pu_id
            # replicas charge amortized steady-state load (time == frame_time
            # on unreplicated graphs)
            load[best.pu_id] += cm.frame_time(node, best.pu_type, best.speed)
            weights[best.pu_id] += node.weight_bytes

        nodes = schedulable_nodes(g)
        for group in (
            [n for n in nodes if n.node_id in lp_set],
            [n for n in nodes if n.node_id not in lp_set],
        ):
            for pu_type in (PUType.IMC, PUType.DPU):
                batch = [n for n in group if n.pu_type == pu_type]
                batch.sort(key=lambda n: (-cm.time(n), n.node_id))
                for node in batch:
                    assign(node)
        return mapping

    # -- phase 2: local search -------------------------------------------------
    def _objective(self, g: Graph, pus: Sequence[PUSpec],
                   mapping: Dict[int, int]) -> tuple:
        from ..simulator import IMCESimulator  # local import: avoid cycle

        a = Assignment(mapping=mapping, pus=list(pus), algorithm="tmp")
        bneck = a.bottleneck(g, self.cm)
        lat = IMCESimulator(g, self.cm).latency_only(a)
        return (bneck, lat)

    def _refine(self, g: Graph, pus: Sequence[PUSpec],
                mapping: Dict[int, int]) -> Dict[int, int]:
        cm = self.cm
        best = dict(mapping)
        best_obj = self._objective(g, pus, best)
        budget = self.refine_budget
        nodes = [n for n in schedulable_nodes(g)]
        pu_by_id = {p.pu_id: p for p in pus}
        improved = True
        while improved and budget > 0:
            improved = False
            # moves
            for n in nodes:
                for p in self._compatible(n, pus):
                    if best[n.node_id] == p.pu_id:
                        continue
                    cand = dict(best)
                    cand[n.node_id] = p.pu_id
                    if not self._cap_ok(g, pus, cand):
                        continue
                    budget -= 1
                    obj = self._objective(g, pus, cand)
                    if obj < best_obj:
                        best, best_obj, improved = cand, obj, True
                        break
                    if budget <= 0:
                        break
                if improved or budget <= 0:
                    break
            if improved or budget <= 0:
                continue
            # swaps
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    if a.pu_type != b.pu_type or best[a.node_id] == best[b.node_id]:
                        continue
                    cand = dict(best)
                    cand[a.node_id], cand[b.node_id] = cand[b.node_id], cand[a.node_id]
                    if not self._cap_ok(g, pus, cand):
                        continue
                    budget -= 1
                    obj = self._objective(g, pus, cand)
                    if obj < best_obj:
                        best, best_obj, improved = cand, obj, True
                        break
                    if budget <= 0:
                        break
                if improved or budget <= 0:
                    break
        return best

    def _cap_ok(self, g: Graph, pus: Sequence[PUSpec],
                mapping: Dict[int, int]) -> bool:
        used: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        caps = {p.pu_id: p.capacity(self.cm.profile) for p in pus}
        for nid, pid in mapping.items():
            used[pid] += g.nodes[nid].weight_bytes
            if used[pid] > caps[pid] * (1 + 1e-9):
                return False
        return True

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        mapping = self._greedy(g, pus)
        if not self._cap_ok(g, pus, mapping):
            # fall back to plain LBLP (its waiver bookkeeping) when the
            # comm-aware greedy overpacks a PU
            mapping = LBLPScheduler(self.cm).schedule(g, pus).mapping
        refined = self._refine(g, pus, mapping)
        return Assignment(mapping=refined, pus=list(pus), algorithm=self.name)
