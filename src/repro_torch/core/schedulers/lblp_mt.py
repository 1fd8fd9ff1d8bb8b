"""LBLP-MT — multi-tenant Load-Balance Longest-Path co-scheduling.

The paper's Algorithm 1 maps one CNN onto the fleet; under multi-tenant
serving (several models resident at once, each with its own frame stream)
running it verbatim on the disjoint union is biased: the union's single
longest path belongs to the *heaviest* tenant, so only that tenant's
critical path receives the LP-first treatment and the others are placed
as an afterthought.

LBLP-MT generalizes steps 1-3 to the union:

  1. Identify every tenant's longest path (disjoint components make the
     per-tenant LP exact on the union's topological order).
  2. Per PU type, round-robin across tenants — heaviest-LP tenant first —
     taking each tenant's LP nodes in descending execution time, and
     assign min-load with the capacity constraint.  Interleaving keeps
     every tenant's critical path spread over the least-loaded PUs
     instead of letting one tenant monopolize them.
  3. Non-LP nodes of all tenants follow, sorted descending, with the
     parallel-branch constraint evaluated *within* a tenant only: across
     tenants every pair is trivially parallel, so the intra-graph branch
     separation rule would otherwise degenerate into noise.

On a single-model graph LBLP-MT reduces exactly to LBLP.

Tenant weights (serving priority)
---------------------------------
Per-tenant weights — from ``MultiTenantGraph.tenant_weight`` or the
``tenant_weights`` constructor override — scale each tenant's claim in
the interleave: tenants are ordered by *weighted* longest-path time, so
a weight-2 tenant's critical path picks least-loaded PUs before an
equally heavy weight-1 tenant's.  The same weights drive the
simulator's weighted fair queueing (a weight-w tenant receives w times
the fleet share), so scheduler and runtime agree on who the priority
tenants are.  All weights defaulting to 1.0 reproduces the historical
unweighted behaviour exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..cost import PUSpec
from ..graph import Graph, MultiTenantGraph, Node, PUType
from .base import Assignment, Scheduler, schedulable_nodes
from .lblp import LBLPScheduler


class LBLPMTScheduler(Scheduler):
    name = "lblp-mt"

    def __init__(self, cost_model=None, branch_constraint: bool = True,
                 tenant_weights: Optional[Dict[str, float]] = None) -> None:
        super().__init__(cost_model)
        self.branch_constraint = branch_constraint
        #: optional per-tenant weight override; tenants absent here fall
        #: back to the graph's own ``tenant_weight`` (default 1.0)
        self.tenant_weights = dict(tenant_weights or {})

    def _tenant_weight(self, g: MultiTenantGraph, tenant: str) -> float:
        w = self.tenant_weights.get(tenant)
        return w if w is not None else g.tenant_weight(tenant)

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        if not isinstance(g, MultiTenantGraph) or len(g.tenants) <= 1:
            a = LBLPScheduler(self.cm, self.branch_constraint).schedule(g, pus)
            a.algorithm = self.name
            return a
        cm = self.cm
        mapping: Dict[int, int] = {}
        load: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        spills: List[int] = []

        # Step 1: per-tenant longest paths, heaviest tenant first.
        # Fleet-independent, so cached on the graph (cleared on mutation)
        # — lblp-r probes and elastic events re-schedule one union often.
        lp_key = ("lblp-mt-lp", type(cm), cm.profile)
        hit = g.scratch().get(lp_key)
        if hit is None:
            lp_of = {t: g.tenant_longest_path(t, lambda n: cm.time(n))
                     for t in g.tenants}
            lp_time = {t: sum(cm.time(g.nodes[n]) for n in lp_of[t])
                       for t in g.tenants}
            g.scratch()[lp_key] = (lp_of, lp_time)
        else:
            lp_of, lp_time = hit
        # weighted priority order: a tenant's claim on the least-loaded
        # PUs scales with weight * critical-path time (weight 1.0
        # everywhere == the historical unweighted order)
        wt = {t: self._tenant_weight(g, t) for t in g.tenants}
        tenant_order = sorted(g.tenants,
                              key=lambda t: (-lp_time[t] * wt[t], t))
        lp_set = {n for lp in lp_of.values() for n in lp}

        def same_tenant_parallel(a: int, b: int) -> bool:
            # branch separation only matters within a tenant: across
            # tenants every pair is trivially parallel.
            return (g.nodes[a].meta.get("tenant") == g.nodes[b].meta.get("tenant")
                    and g.is_parallel(a, b))

        conflicts = same_tenant_parallel if self.branch_constraint else None
        on_pu: Dict[int, List[int]] = {p.pu_id: [] for p in pus}

        def assign(node: Node, candidates: List[PUSpec]) -> None:
            self._assign_min_load(node, candidates, mapping, load, weights,
                                  spills, conflicts, on_pu)

        # Step 2: interleaved LP assignment, per PU type.
        for pu_type in (PUType.IMC, PUType.DPU):
            queues: List[List[Node]] = []
            for t in tenant_order:
                batch = [g.nodes[n] for n in lp_of[t]
                         if not g.nodes[n].is_free()
                         and g.nodes[n].pu_type == pu_type]
                batch.sort(key=lambda n: (-cm.time(n), n.node_id))
                queues.append(batch)
            depth = max((len(q) for q in queues), default=0)
            for rank in range(depth):
                for q in queues:
                    if rank < len(q):
                        node = q[rank]
                        assign(node, self._compatible(node, pus))

        # Step 3: non-LP nodes of all tenants, descending execution time.
        rest = [n for n in schedulable_nodes(g) if n.node_id not in lp_set]
        for pu_type in (PUType.IMC, PUType.DPU):
            batch = [n for n in rest if n.pu_type == pu_type]
            batch.sort(key=lambda n: (-cm.time(n), n.node_id))
            for node in batch:
                assign(node, self._compatible(node, pus))

        return Assignment(
            mapping=mapping,
            pus=list(pus),
            algorithm=self.name,
            meta={
                "longest_paths": {t: lp_of[t] for t in tenant_order},
                "capacity_spills": spills,
                "tenant_weights": wt,
            },
        )
