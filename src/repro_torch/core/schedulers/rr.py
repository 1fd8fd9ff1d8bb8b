"""Round-Robin (RR) — paper §IV.

"The algorithm first performs a topological sort on the network to
establish a valid execution order and then sorts nodes in ascending order
based on their unique node IDs.  The nodes are then assigned sequentially
to PUs in a round-robin fashion."

PU-type compatibility still applies (a pooling node cannot run on an IMC
PU), so the rotation is maintained *per PU type*, cycling through the
compatible sub-fleet — the natural reading of the paper's description on
a hybrid fleet.  Capacity overflows fall through to the next PU in the
cycle.
"""

from __future__ import annotations

from typing import Dict, Sequence

from ..cost import PUSpec
from ..graph import Graph, PUType
from .base import Assignment, Scheduler


class RRScheduler(Scheduler):
    name = "rr"

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        mapping: Dict[int, int] = {}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        cursor: Dict[PUType, int] = {PUType.IMC: 0, PUType.DPU: 0}
        spills = []

        order = sorted(g.topo_order())  # topo sort, then ascending node id
        for nid in order:
            node = g.nodes[nid]
            if node.is_free():
                continue
            cands = self._compatible(node, pus)
            k = cursor[node.pu_type] % len(cands)
            # advance past full PUs if any PU still fits the node
            chosen = None
            for off in range(len(cands)):
                p = cands[(k + off) % len(cands)]
                if self._fits(node, p, weights):
                    chosen = p
                    cursor[node.pu_type] = (k + off + 1)
                    break
            if chosen is None:
                chosen = cands[k]
                cursor[node.pu_type] = k + 1
                spills.append(nid)
            mapping[nid] = chosen.pu_id
            weights[chosen.pu_id] += node.weight_bytes

        return Assignment(mapping=mapping, pus=list(pus), algorithm=self.name,
                          meta={"capacity_spills": spills})
