"""Branch-and-bound optimal load balancer (beyond-paper quality bound).

Minimizes the pipeline bottleneck ``max_pu(total assigned time)`` —
the quantity that determines steady-state processing rate — exactly,
subject to PU-type compatibility and weight capacity.  Exponential in
the worst case; intended for graphs up to ~25 schedulable nodes (ResNet8
easily, ResNet18 with the default beam cap).  Used in tests/benchmarks to
measure how far LBLP sits from the optimum.

The search assigns nodes in descending execution-time order (strongest
pruning), with two bounds:
  * partial bottleneck >= incumbent  -> prune
  * (sum of remaining time)/|PUs| + ... relaxation cannot beat incumbent -> prune
Symmetry: identical empty PUs are interchangeable; only the first empty
PU of each type is branched on.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from ..cost import PUSpec
from ..graph import Graph, PUType
from .base import Assignment, Scheduler, schedulable_nodes


class OptimalScheduler(Scheduler):
    name = "optimal"

    def __init__(self, cost_model=None, node_limit: int = 26,
                 max_expansions: int = 2_000_000) -> None:
        super().__init__(cost_model)
        self.node_limit = node_limit
        self.max_expansions = max_expansions

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        cm = self.cm
        nodes = schedulable_nodes(g)
        if len(nodes) > self.node_limit:
            raise ValueError(
                f"optimal scheduler limited to {self.node_limit} nodes "
                f"(got {len(nodes)}); use lblp/heft for larger graphs"
            )
        # group nodes by type; the bottleneck decomposes per-type only if
        # fleets are disjoint (they are: IMC vs DPU), so solve separately.
        mapping: Dict[int, int] = {}
        best_bneck = 0.0
        for pu_type in (PUType.IMC, PUType.DPU):
            sub = [n for n in nodes if n.pu_type == pu_type]
            fleet = [p for p in pus if p.pu_type == pu_type]
            if not sub:
                continue
            if not fleet:
                fleet = [p for p in pus
                         if not math.isinf(cm.time(sub[0], p.pu_type, p.speed))]
            sub.sort(key=lambda n: (-cm.time(n), n.node_id))
            times = [cm.time(n) for n in sub]
            wts = [n.weight_bytes for n in sub]
            caps = [p.capacity(cm.profile) for p in fleet]

            incumbent = [math.inf]
            best_assign: List[Optional[List[int]]] = [None]
            loads = [0.0] * len(fleet)
            used_w = [0.0] * len(fleet)
            assign = [0] * len(sub)
            expansions = [0]

            suffix = [0.0] * (len(sub) + 1)
            for i in range(len(sub) - 1, -1, -1):
                suffix[i] = suffix[i + 1] + times[i]

            n_sub, n_fleet = len(sub), len(fleet)

            def dfs(i: int) -> None:
                if expansions[0] > self.max_expansions:
                    return
                expansions[0] += 1
                if i == n_sub:
                    b = max(loads)
                    if b < incumbent[0]:
                        incumbent[0] = b
                        best_assign[0] = list(assign)
                    return
                # relaxation bound: even perfectly spreading the rest can't
                # get below max(current max-free average, biggest single
                # item); loads are non-negative so max(loads) needs no
                # emptiness/zero guard
                lb = max(
                    max(loads),
                    (sum(loads) + suffix[i]) / n_fleet,
                    times[i],
                )
                if lb >= incumbent[0] - 1e-15:
                    return
                seen_empty = False
                order = sorted(range(n_fleet), key=loads.__getitem__)
                for j in order:
                    if loads[j] == 0.0:
                        if seen_empty:
                            continue  # symmetry break
                        seen_empty = True
                    if used_w[j] + wts[i] > caps[j] * (1 + 1e-9):
                        continue
                    loads[j] += times[i]
                    used_w[j] += wts[i]
                    assign[i] = j
                    dfs(i + 1)
                    loads[j] -= times[i]
                    used_w[j] -= wts[i]

            dfs(0)
            if best_assign[0] is None:
                raise RuntimeError("branch-and-bound found no feasible packing")
            for n, j in zip(sub, best_assign[0]):
                mapping[n.node_id] = fleet[j].pu_id
            best_bneck = max(best_bneck, incumbent[0])

        return Assignment(mapping=mapping, pus=list(pus), algorithm=self.name,
                          meta={"optimal_bottleneck": best_bneck})
