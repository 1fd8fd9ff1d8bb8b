"""Weights-Balance (WB) — the paper's Algorithm 2.

Step 1: IMC nodes sorted descending by *weights size*; each goes to the
IMC PU with the smallest assigned weights size.
Step 2: DPU nodes sorted descending by *execution time*; each goes to the
DPU PU with the smallest total execution time.

WB balances crossbar area, not time — the paper shows this concentrates
the compute-heavy early conv layers (big activations, small kernels) onto
few PUs, collapsing utilization (Table I: 24.4% mean vs LBLP's 78.3%).
"""

from __future__ import annotations

from typing import Dict, Sequence

from ..cost import PUSpec
from ..graph import Graph, PUType
from .base import Assignment, Scheduler, schedulable_nodes


class WBScheduler(Scheduler):
    name = "wb"

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        cm = self.cm
        mapping: Dict[int, int] = {}
        load: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        spills = []

        nodes = schedulable_nodes(g)

        # Step 1: IMC nodes by descending weight size -> min-weights PU.
        imc_nodes = sorted(
            (n for n in nodes if n.pu_type == PUType.IMC),
            key=lambda n: (-n.weight_bytes, n.node_id),
        )
        for node in imc_nodes:
            cands = self._compatible(node, pus)
            pool = [p for p in cands if self._fits(node, p, weights)]
            if not pool:
                pool = cands
                spills.append(node.node_id)
            best = min(pool, key=lambda p: (weights[p.pu_id], p.pu_id))
            mapping[node.node_id] = best.pu_id
            weights[best.pu_id] += node.weight_bytes
            # replicas charge amortized steady-state load (time == frame_time
            # on unreplicated graphs)
            load[best.pu_id] += cm.frame_time(node, best.pu_type, best.speed)

        # Step 2: DPU nodes by descending execution time -> min-load PU.
        dpu_nodes = sorted(
            (n for n in nodes if n.pu_type == PUType.DPU),
            key=lambda n: (-cm.time(n), n.node_id),
        )
        for node in dpu_nodes:
            cands = self._compatible(node, pus)
            best = min(cands, key=lambda p: (load[p.pu_id], p.pu_id))
            mapping[node.node_id] = best.pu_id
            # replicas charge amortized steady-state load (time == frame_time
            # on unreplicated graphs)
            load[best.pu_id] += cm.frame_time(node, best.pu_type, best.speed)

        return Assignment(mapping=mapping, pus=list(pus), algorithm=self.name,
                          meta={"capacity_spills": spills})
