"""Serve a churning tenant population under SLOs: the control plane.

Walkthrough of the serving tier (`repro_torch.core.serving`):

  1. stand up a ServingControlPlane over an 8 IMC + 4 DPU fleet with a
     two-model registry,
  2. replay a hand-written trace: three arrivals with rate/latency
     promises (one of them too greedy — it gets rejected), a PU
     failure, a priority bump, a departure,
  3. read the audit trail: every decision with its reason, and a
     per-tenant SLOReport of promise vs attainment.

The plane probes every candidate state in the simulator before
committing, reclaims replicas to make room for admissible newcomers,
and spends spare capacity on the hottest tenant's bottleneck layers
(LRMP-style replication) — watch for the "replicate" decisions.

Run: PYTHONPATH=src python examples/torch/serve_with_slos.py
"""

from repro_torch.core import CostModel, make_pus
from repro_torch.core.serving import SLO, ServingControlPlane, TraceEvent
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph


def main() -> None:
    cm = CostModel()
    models = {"resnet8": resnet8_graph(), "resnet18": resnet18_graph()}
    plane = ServingControlPlane(make_pus(8, 4), models, cost_model=cm,
                                engine="periodic", frames=64)

    trace = [
        # a camera pipeline: modest rate floor, real latency ceiling
        TraceEvent("arrive", tenant="cam-0", model="resnet8",
                   slo=SLO(min_rate=300.0, max_latency=0.05)),
        # a bulk classifier: throughput only, double priority
        TraceEvent("arrive", tenant="bulk-0", model="resnet18",
                   slo=SLO(min_rate=400.0), weight=2.0),
        # too greedy for what is left — expect a rejection
        TraceEvent("arrive", tenant="greedy", model="resnet8",
                   slo=SLO(min_rate=5000.0)),
        TraceEvent("fail", pu_id=3),
        TraceEvent("load", tenant="cam-0", weight=2.0),
        TraceEvent("join", pu_id=3, pu_type="imc"),
        TraceEvent("depart", tenant="bulk-0"),
    ]
    plane.play(trace)

    print("== decision log ==")
    for d in plane.decisions:
        print(f"[{d.index}] {d.event:<12s} {d.action:<9s} "
              f"{(d.tenant or '-'):<8s} {d.reason}")

    print("\n== SLO reports ==")
    print(f"{'tenant':<8s} {'promise':<28s} {'outcome':<10s} "
          f"{'worst rate':>10s} {'violations'}")
    for t, r in sorted(plane.reports.items()):
        promise = []
        if r.slo.min_rate:
            promise.append(f">={r.slo.min_rate:.0f} fps")
        if r.slo.max_latency:
            promise.append(f"<={r.slo.max_latency * 1e3:.0f} ms")
        if r.rejected_index is not None:
            outcome = "rejected"
        elif r.evicted_index is not None:
            outcome = "evicted"
        else:
            outcome = "satisfied" if r.satisfied() else "violated"
        worst = min((s[1] for s in r.samples), default=float("nan"))
        print(f"{t:<8s} {', '.join(promise):<28s} {outcome:<10s} "
              f"{worst:10.0f} {r.violations}")

    print(f"\n{plane.probes} what-if probes over {plane.n_events} trace "
          f"events; final replicas {plane.replicas}")


if __name__ == "__main__":
    main()
