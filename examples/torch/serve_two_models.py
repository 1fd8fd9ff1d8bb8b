"""Serve two CNNs from one PU fleet: co-schedule, stream, survive a failure.

Walkthrough of the multi-tenant tier:

  1. build the tagged union of ResNet-8 and ResNet-18,
  2. co-place it on a 8 IMC + 4 DPU fleet with lblp-mt,
  3. drive both frame streams — saturated, then open-loop at a camera-ish
     30 fps for one tenant while the other takes the leftovers,
  4. kill a PU: the elastic session re-co-schedules *all* tenants at once.

Run: PYTHONPATH=src python examples/torch/serve_two_models.py
"""

from repro_torch.core import (CostModel, MultiTenantGraph, MultiTenantSimulator,
                        get_scheduler, make_pus)
from repro_torch.core.elastic import ElasticSession
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph


def show(title: str, result) -> None:
    print(f"\n-- {title} --")
    print(f"{'tenant':<16s} {'rate_fps':>9s} {'lat_ms':>8s} {'util_share':>11s}")
    for t, m in result.tenants.items():
        print(f"{t:<16s} {m.rate:9.0f} {m.latency*1e3:8.2f} "
              f"{m.utilization_share:11.2f}")


def main() -> None:
    mt = MultiTenantGraph.union([resnet8_graph(), resnet18_graph()])
    cm = CostModel()
    fleet = make_pus(8, 4)
    print(f"union: {len(mt)} nodes, tenants {mt.tenants}")

    a = get_scheduler("lblp-mt", cm).schedule(mt, fleet)
    bn = a.tenant_bottleneck(mt, cm)
    print("per-tenant load bound:",
          {t: f"{v*1e6:.0f}us" for t, v in bn.items()})

    sim = MultiTenantSimulator(mt, cm)
    show("saturated (closed-loop) co-serving", sim.run(a, frames=64))

    rates = {"resnet8": 30.0, "resnet18_cifar": 1000.0}
    show(f"open-loop injection {rates}", sim.run(a, frames=64, rates=rates))

    print("\n-- PU 3 fails: one elastic pass re-places every tenant --")
    sess = ElasticSession(mt, fleet, cost_model=cm)
    ev = sess.fail(3)
    print(f"{'tenant':<16s} {'rate_fps':>9s} {'lat_ms':>8s}")
    for t in mt.tenants:
        print(f"{t:<16s} {ev.tenant_rates[t]:9.0f} "
              f"{ev.tenant_latencies[t]*1e3:8.2f}")


if __name__ == "__main__":
    main()
