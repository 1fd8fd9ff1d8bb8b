"""Beyond-paper: multi-tenant co-scheduling vs static fleet partitioning.

Several CNNs resident on one PU fleet at once, each with its own frame
stream.  Two deployment policies:

* **static**   — the fleet is partitioned evenly; every model gets its own
  slice and is scheduled alone on it with LBLP (the obvious "one model per
  sub-fleet" ops policy).
* **co-sched** — the tagged union of all models is placed on the *whole*
  fleet by one scheduler (lblp-mt, with rr/wb as baselines) and all
  streams share every PU.

Co-scheduling can always emulate the partition, so its aggregate rate
should match or beat static; the win grows when tenants are heterogeneous
(a static slice sized for the light model idles while the heavy model's
slice saturates).  Per-tenant rate/latency come from the multi-tenant
simulator's ``SimResult.tenants``.
"""

from __future__ import annotations

from repro_torch.core import CostModel, MultiTenantGraph, get_scheduler, make_pus
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph

from .common import csv_line, dump, make_sim

CO_ALGS = ("lblp-mt", "rr", "wb")


def split_fleet_evenly(n_imc: int, n_dpu: int, n_tenants: int):
    """Round-robin the fleet into ``n_tenants`` disjoint slices.

    Every slice keeps the global PU ids (slice k gets IMC PUs k,
    k+n_tenants, ... and likewise DPUs) so static results stay comparable.
    """
    full = make_pus(n_imc, n_dpu)
    imc = [p for p in full if p.pu_type.value == "imc"]
    dpu = [p for p in full if p.pu_type.value == "dpu"]
    return [imc[k::n_tenants] + dpu[k::n_tenants] for k in range(n_tenants)]


def static_partition(graphs, tenants, n_imc: int, n_dpu: int, cm: CostModel,
                     frames: int) -> dict:
    """One model per fleet slice; keyed by the union's deduplicated tenant
    names so duplicate models stay distinct entries."""
    slices = split_fleet_evenly(n_imc, n_dpu, len(graphs))
    per_tenant = {}
    for g, tenant, sl in zip(graphs, tenants, slices):
        if not sl:
            raise ValueError("fleet too small to give every tenant a slice")
        a = get_scheduler("lblp", cm).schedule(g, sl)
        r = make_sim(g, cm).run(a, frames=frames)
        per_tenant[tenant] = {"rate": r.rate, "latency": r.latency,
                              "n_pus": len(sl)}
    return {
        "aggregate_rate": sum(v["rate"] for v in per_tenant.values()),
        "tenants": per_tenant,
    }


def co_scheduled(mt: MultiTenantGraph, n_imc: int, n_dpu: int, alg: str,
                 cm: CostModel, frames: int) -> dict:
    fleet = make_pus(n_imc, n_dpu)
    a = get_scheduler(alg, cm).schedule(mt, fleet)
    r = make_sim(mt, cm).run(a, frames=frames)
    return {
        "aggregate_rate": sum(m.rate for m in r.tenants.values()),
        "mean_utilization": r.mean_utilization,
        "tenants": {t: {"rate": m.rate, "latency": m.latency,
                        "utilization_share": m.utilization_share}
                    for t, m in r.tenants.items()},
    }


def main(frames: int = 96) -> dict:
    cm = CostModel()
    # one graph object per resident model (a model registry): workloads
    # that serve the same model share its compiled simulation context,
    # cached schedules and memoized runs across cells
    rn8_a, rn8_b, rn18 = resnet8_graph(), resnet8_graph(), resnet18_graph()
    workloads = [
        ("2x resnet8", [rn8_a, rn8_b]),
        ("resnet8+resnet18", [rn8_a, rn18]),
        ("2x rn8 + rn18", [rn8_a, rn8_b, rn18]),
    ]
    fleets = [(4, 2), (8, 4), (12, 6)]
    out = {"fleets": [], "frames": frames}
    for wl_name, graphs in workloads:
        mt = MultiTenantGraph.union(graphs)
        for n_imc, n_dpu in fleets:
            if n_imc < len(graphs) or n_dpu < len(graphs):
                continue  # static baseline needs one PU of each type per tenant
            cell = {"workload": wl_name, "n_imc": n_imc, "n_dpu": n_dpu}
            cell["static"] = static_partition(graphs, mt.tenants, n_imc,
                                              n_dpu, cm, frames)
            for alg in CO_ALGS:
                cell[alg] = co_scheduled(mt, n_imc, n_dpu, alg, cm, frames)
            out["fleets"].append(cell)

    print(f"{'workload':<18s} {'fleet':>7s} {'static':>9s} "
          + "".join(f"{a:>9s}" for a in CO_ALGS) + "   co/static")
    for cell in out["fleets"]:
        s = cell["static"]["aggregate_rate"]
        co = cell["lblp-mt"]["aggregate_rate"]
        row = (f"{cell['workload']:<18s} {cell['n_imc']}+{cell['n_dpu']:<4d} "
               f"{s:9.0f}" + "".join(
                   f"{cell[a]['aggregate_rate']:9.0f}" for a in CO_ALGS))
        print(row + f" {co / s:10.2f}x")
        csv_line(
            f"multi_tenant.{cell['workload'].replace(' ', '')}"
            f".{cell['n_imc']}+{cell['n_dpu']}",
            0.0, f"{co / s:.3f}")
    # per-tenant detail for the heterogeneous 8+4 cell
    detail = next(c for c in out["fleets"]
                  if c["workload"] == "resnet8+resnet18"
                  and (c["n_imc"], c["n_dpu"]) == (8, 4))
    print("\nper-tenant (resnet8+resnet18, 8+4 fleet, lblp-mt co-schedule):")
    print(f"{'tenant':<16s} {'rate_fps':>9s} {'lat_ms':>8s} {'util_share':>11s}"
          f" {'static_fps':>11s}")
    for t, m in detail["lblp-mt"]["tenants"].items():
        st_rate = detail["static"]["tenants"][t]["rate"]
        print(f"{t:<16s} {m['rate']:9.0f} {m['latency']*1e3:8.2f} "
              f"{m['utilization_share']:11.2f} {st_rate:11.0f}")
    wins = sum(1 for c in out["fleets"]
               if c["lblp-mt"]["aggregate_rate"]
               >= c["static"]["aggregate_rate"] * 0.99)
    print(f"\nco-scheduled lblp-mt >= static on {wins}/{len(out['fleets'])} cells")
    out["wins"] = wins
    path = dump("multi_tenant", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
