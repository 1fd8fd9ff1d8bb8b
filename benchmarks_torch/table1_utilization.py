"""Paper Table I — ResNet18 on 12 PUs (8 IMC + 4 DPU): per-PU node
placement, normalized weights area, and utilization for LBLP vs WB."""

from repro_torch.core import CostModel, get_scheduler, make_pus
from repro_torch.core.graph import PUType
from repro_torch.models.cnn.graphs import resnet18_graph

from .common import csv_line, dump, make_sim


def main() -> dict:
    g = resnet18_graph()
    cm = CostModel()
    sim = make_sim(g, cm)
    fleet = make_pus(8, 4)
    out = {}
    for alg in ("lblp", "wb"):
        a = get_scheduler(alg, cm).schedule(g, fleet)
        r = sim.run(a, frames=128)
        weights = a.weights(g)
        wmax = max(weights[p] for p in range(1, 9)) or 1.0
        rows = []
        print(f"\n== Table I ({alg.upper()}) — IMC PUs ==")
        print("PU  nodes                      weights%  util%")
        for p in range(1, 9):
            nodes = [n for n in a.nodes_on(p)
                     if g.nodes[n].pu_type == PUType.IMC]
            rows.append({
                "pu": p, "nodes": nodes,
                "weights_pct": 100.0 * weights[p] / wmax,
                "utilization_pct": 100.0 * r.utilization[p],
            })
            print(f"{p:<3d} {str(nodes):<26s} {rows[-1]['weights_pct']:7.1f} "
                  f"{rows[-1]['utilization_pct']:6.1f}")
        imc_mean = sum(r.utilization[p] for p in range(1, 9)) / 8
        all_mean = r.mean_utilization
        print(f"mean IMC-PU utilization: {imc_mean*100:.1f}%   "
              f"(all-PU: {all_mean*100:.1f}%)")
        out[alg] = {"rows": rows, "imc_mean_util": imc_mean,
                    "all_mean_util": all_mean, "rate_fps": r.rate,
                    "latency_s": r.latency}
        csv_line(f"table1.{alg}.imc_mean_util_pct", 0.0, f"{imc_mean*100:.1f}")
    print("\npaper: LBLP 78.3% vs WB 24.4% mean utilization")
    path = dump("table1_utilization", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
