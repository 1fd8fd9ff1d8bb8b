"""Quickstart: schedule ResNet8 onto a hybrid IMC/DPU fleet with the
paper's four algorithms and compare (the paper's core experiment in ~30
lines).

    PYTHONPATH=src python examples/torch/quickstart.py
"""

from repro_torch.core import (CostModel, IMCESimulator, get_scheduler, make_pus,
                        normalize, utilization_table)
from repro_torch.models.cnn.graphs import resnet8_graph


def main() -> None:
    graph = resnet8_graph()
    cm = CostModel()
    fleet = make_pus(n_imc=4, n_dpu=2)          # 6-PU hybrid device
    sim = IMCESimulator(graph, cm)

    print(f"{graph.name}: {len(graph)} nodes "
          f"({graph.num_nodes(kind=None)} total, "
          f"{graph.total_weight_bytes()/1e3:.0f} KB weights)\n")

    results = {}
    for alg in ("lblp", "wb", "rr", "rd"):
        assignment = get_scheduler(alg, cm).schedule(graph, fleet)
        assignment.validate(graph, cm, check_capacity=False)
        results[alg] = sim.run(assignment, frames=96)

    print("alg     rate[fps]  latency[ms]  norm_rate  norm_lat  mean_util")
    for alg, pt in normalize(results).items():
        print(f"{alg:6s} {pt.rate:10.1f} {pt.latency*1e3:12.3f}"
              f" {pt.norm_rate:10.3f} {pt.norm_latency:9.3f}"
              f" {pt.mean_utilization*100:9.1f}%")

    print("\nLBLP per-PU utilization:")
    print(utilization_table(results["lblp"]))


if __name__ == "__main__":
    main()
