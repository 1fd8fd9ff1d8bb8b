"""Random (RD) — paper §IV.

"Initially, a number of nodes equal to the available PUs are randomly
selected and assigned to different PUs to ensure full utilization of
resources.  The remaining nodes are then assigned randomly to a PU."

Type compatibility is respected: the seeding phase draws, per PU, a
random not-yet-assigned node executable on it; the fill phase assigns
each remaining node to a uniformly random compatible PU (retrying on
capacity overflow, then waiving).
"""

from __future__ import annotations

import random
from typing import Dict, Sequence

from ..cost import PUSpec
from ..graph import Graph
from .base import Assignment, Scheduler, schedulable_nodes


class RDScheduler(Scheduler):
    name = "rd"

    def __init__(self, cost_model=None, seed: int = 0) -> None:
        super().__init__(cost_model)
        self.seed = seed

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        rng = random.Random(self.seed)
        mapping: Dict[int, int] = {}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        spills = []

        remaining = {n.node_id: n for n in schedulable_nodes(g)}

        # Phase 1: seed every PU with one random compatible node.
        for p in rng.sample(list(pus), len(pus)):
            cands = [
                n for n in remaining.values()
                if p in self._compatible(n, pus) and self._fits(n, p, weights)
            ]
            if not cands:
                continue
            node = rng.choice(sorted(cands, key=lambda n: n.node_id))
            mapping[node.node_id] = p.pu_id
            weights[p.pu_id] += node.weight_bytes
            del remaining[node.node_id]

        # Phase 2: everything else goes to a random compatible PU.
        for nid in sorted(remaining):
            node = remaining[nid]
            cands = self._compatible(node, pus)
            pool = [p for p in cands if self._fits(node, p, weights)]
            if not pool:
                pool = cands
                spills.append(nid)
            p = rng.choice(pool)
            mapping[nid] = p.pu_id
            weights[p.pu_id] += node.weight_bytes

        return Assignment(mapping=mapping, pus=list(pus), algorithm=self.name,
                          meta={"seed": self.seed, "capacity_spills": spills})
