"""Load-Balance Longest-Path (LBLP) — the paper's Algorithm 1.

Steps (verbatim from the paper):

  1. Identify the Longest Path (LP): the sequence of nodes forming the
     path with the highest total execution time.
  2. For each processing type (IMC/DPU), sort the LP nodes in descending
     order of execution time.
  3. Assign each LP node to the compatible PU with the smallest total
     assigned execution time; update that PU's total.
  4. Repeat step 3 for the non-LP nodes (also sorted descending), while
     enforcing the parallel-branch constraint: nodes on parallel branches
     are assigned, if possible, to *different* PUs (maximizes pipeline
     parallelism).

Our implementation additionally respects the IMC weight-capacity
constraint (Table I normalizes per-PU "weights area" to 100%, implying a
hard capacity): a PU whose crossbars cannot hold the node's weights is
skipped; if no compatible PU fits, capacity is waived for that node (the
emulator spills to DRAM) and the event is recorded in ``meta``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..cost import PUSpec
from ..graph import Graph, Node, PUType
from .base import Assignment, Scheduler, schedulable_nodes


class LBLPScheduler(Scheduler):
    name = "lblp"

    def __init__(self, cost_model=None, branch_constraint: bool = True) -> None:
        super().__init__(cost_model)
        self.branch_constraint = branch_constraint

    def schedule(self, g: Graph, pus: Sequence[PUSpec]) -> Assignment:
        cm = self.cm
        mapping: Dict[int, int] = {}
        load: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        weights: Dict[int, float] = {p.pu_id: 0.0 for p in pus}
        spills: List[int] = []

        # Step 1: longest path by execution time (on native PU type).
        # Fleet-independent, so cached on the graph (cleared on mutation)
        # — elastic sessions and lblp-r probes re-schedule one graph many
        # times over changing fleets.
        lp_key = ("lblp-lp", type(cm), cm.profile)
        lp = g.scratch().get(lp_key)
        if lp is None:
            lp = g.scratch()[lp_key] = g.longest_path(lambda n: cm.time(n))
        lp_set = set(lp)

        # prefer PUs holding no node parallel to this one
        conflicts = g.is_parallel if self.branch_constraint else None
        on_pu: Dict[int, List[int]] = {p.pu_id: [] for p in pus}

        def assign(node: Node, candidates: List[PUSpec]) -> None:
            self._assign_min_load(node, candidates, mapping, load, weights,
                                  spills, conflicts, on_pu)

        # Steps 2-3: LP nodes, per type, descending execution time.
        lp_nodes = [g.nodes[n] for n in lp if not g.nodes[n].is_free()]
        for pu_type in (PUType.IMC, PUType.DPU):
            batch = [n for n in lp_nodes if n.pu_type == pu_type]
            batch.sort(key=lambda n: (-cm.time(n), n.node_id))
            for node in batch:
                assign(node, self._compatible(node, pus))

        # Step 4: non-LP nodes, same procedure (+ branch constraint).
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
            meta={"longest_path": lp, "capacity_spills": spills},
        )
