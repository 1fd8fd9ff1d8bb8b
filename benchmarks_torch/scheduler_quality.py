"""Beyond-paper: scheduler quality study.

Compares the paper's four algorithms against HEFT / CPOP (related work
[12]), our LBLP-X variant, and — on ResNet8/18-sized graphs — the
branch-and-bound optimum of the pipeline bottleneck.  Reports the
optimality gap of each heuristic."""

import time

from repro_torch.core import CostModel, get_scheduler, make_pus
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph

from .common import csv_line, dump, make_sim

ALGS = ("lblp", "wb", "rr", "rd", "heft", "cpop", "lblp-x")


def main() -> dict:
    cm = CostModel()
    out = {}
    for g, fleets in ((resnet8_graph(), [(4, 2), (7, 3)]),
                      (resnet18_graph(), [(8, 4)])):
        sim = make_sim(g, cm)
        for n_imc, n_dpu in fleets:
            fleet = make_pus(n_imc, n_dpu)
            key = f"{g.name}@{n_imc}+{n_dpu}"
            try:
                t0 = time.perf_counter()
                opt = get_scheduler("optimal", cm).schedule(g, fleet)
                opt_b = opt.bottleneck(g, cm)
                opt_us = (time.perf_counter() - t0) * 1e6
            except ValueError:
                opt_b, opt_us = None, 0.0
            rows = {}
            print(f"\n== {key} (optimal bottleneck: "
                  f"{opt_b*1e6 if opt_b else float('nan'):.1f}us) ==")
            print("alg      rate_fps  latency_us  bneck_gap  sched_us")
            for alg in ALGS:
                t0 = time.perf_counter()
                a = get_scheduler(alg, cm).schedule(g, fleet)
                us = (time.perf_counter() - t0) * 1e6
                r = sim.run(a, frames=96)
                gap = (a.bottleneck(g, cm) / opt_b - 1.0) if opt_b else None
                rows[alg] = {"rate_fps": r.rate, "latency_s": r.latency,
                             "bottleneck_gap": gap, "schedule_time_us": us}
                print(f"{alg:8s} {r.rate:8.1f} {r.latency*1e6:11.1f} "
                      f"{(gap*100 if gap is not None else float('nan')):8.2f}% "
                      f"{us:9.1f}")
                csv_line(f"quality.{g.name}.{alg}.sched", us,
                         f"gap={gap if gap is not None else 'n/a'}")
            out[key] = {"optimal_bottleneck": opt_b,
                        "optimal_time_us": opt_us, "algs": rows}
    path = dump("scheduler_quality", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
