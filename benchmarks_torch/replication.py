"""Beyond-paper: LRMP-style bottleneck layer replication (lblp-r vs lblp).

Sweeps the replica budget and reports the processing-rate gain from
replicating longest-path bottleneck nodes into spare PU capacity
(``Graph.replicate`` round-robin frame splitting, `lblp-r` greedy
budgeted search).  Workloads: ResNet-8 and ResNet-18 single-tenant, plus
the heterogeneous two-tenant serving mix (resnet8+resnet18 co-scheduled
with lblp-mt as the replication base).

``lblp-r`` is run with measured-rate validation (``validate_rate``), so
every cell satisfies rate(lblp-r) >= rate(baseline): the scheduler
reverts to the plain schedule whenever the analytic bound gain fails to
materialize in the discrete-event simulator (finite in-flight buffering
can eat a small bound gain through longer sojourns).  The interesting
figure is how much of the fleet's idle capacity a replica budget
converts into throughput — on fleets with more PUs than heavy layers,
~2x is available (see artifacts/bench_torch/replication.json).
"""

from __future__ import annotations

from repro_torch.core import CostModel, MultiTenantGraph, get_scheduler, make_pus
from repro_torch.core.schedulers.lblp_r import LBLPRScheduler, measured_rate
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph

from . import common
from .common import csv_line, dump

BUDGETS = (1, 2, 4, 8)


def sweep_cell(g, fleet_shape, cm, frames, base_alg):
    n_imc, n_dpu = fleet_shape
    fleet = make_pus(n_imc, n_dpu)
    base_a = get_scheduler(base_alg, cm).schedule(g, fleet)
    base_rate = measured_rate(g, base_a, cm, frames, engine=common.SIM_MODE)
    rows = []
    for budget in BUDGETS:
        sched = LBLPRScheduler(cm, replica_budget=budget,
                               validate_rate=frames,
                               sim_engine=common.SIM_MODE)
        a = sched.schedule(g, fleet)
        g_r = a.meta["replicated_graph"]
        rate = measured_rate(g_r, a, cm, frames, engine=common.SIM_MODE)
        rows.append({
            "budget": budget,
            "rate_base": base_rate,
            "rate_lblp_r": rate,
            "gain": rate / base_rate if base_rate > 0 else 1.0,
            "replicas": {str(k): v for k, v in a.meta["replicas"].items()},
            "extra_replicas": a.meta["extra_replicas"],
            "bound_base": max(base_a.load(g, cm).values()),
            "bound_lblp_r": a.meta["bound_interval"],
        })
    return rows


def main(frames: int = 96) -> dict:
    cm = CostModel()
    workloads = [
        ("resnet8", resnet8_graph(), (8, 4), "lblp"),
        ("resnet8", resnet8_graph(), (12, 6), "lblp"),
        ("resnet18", resnet18_graph(), (12, 6), "lblp"),
        ("resnet18", resnet18_graph(), (16, 8), "lblp"),
        ("rn8+rn18",
         MultiTenantGraph.union([resnet8_graph(), resnet18_graph()]),
         (8, 4), "lblp-mt"),
        ("rn8+rn18",
         MultiTenantGraph.union([resnet8_graph(), resnet18_graph()]),
         (12, 6), "lblp-mt"),
    ]
    out = {"frames": frames, "budgets": list(BUDGETS), "cells": []}
    print(f"{'workload':<10s} {'fleet':>7s} {'budget':>7s} {'base_fps':>9s} "
          f"{'lblp-r':>9s} {'gain':>6s}  replicas")
    for name, g, fleet_shape, base_alg in workloads:
        rows = sweep_cell(g, fleet_shape, cm, frames, base_alg)
        for row in rows:
            out["cells"].append({
                "workload": name,
                "n_imc": fleet_shape[0], "n_dpu": fleet_shape[1],
                **row,
            })
            print(f"{name:<10s} {fleet_shape[0]}+{fleet_shape[1]:<4d} "
                  f"{row['budget']:7d} {row['rate_base']:9.0f} "
                  f"{row['rate_lblp_r']:9.0f} {row['gain']:6.2f}  "
                  f"{row['replicas']}")
            csv_line(
                f"replication.{name}.{fleet_shape[0]}+{fleet_shape[1]}"
                f".b{row['budget']}",
                0.0, f"{row['gain']:.3f}")
    geq = sum(1 for c in out["cells"] if c["rate_lblp_r"] >= c["rate_base"])
    improved = sum(1 for c in out["cells"]
                   if c["rate_lblp_r"] > c["rate_base"] * 1.01)
    out["cells_geq_base"] = geq
    out["cells_improved"] = improved
    print(f"\nlblp-r >= lblp on {geq}/{len(out['cells'])} cells; "
          f"{improved} improved > 1%")
    path = dump("replication", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
