"""Paper Fig. 2 — ResNet8: normalized processing rate & latency vs #PUs
for LBLP / WB / RR / RD."""

from repro_torch.models.cnn.graphs import resnet8_graph

from .common import PAPER_ALGS, csv_line, dump, print_sweep, sweep

# IMC:DPU ratio mirrors the node mix (10 IMC : 4 DPU nodes)
FLEETS = [(2, 1), (3, 1), (4, 2), (5, 2), (6, 3), (7, 3), (8, 3), (10, 4)]


def main() -> dict:
    res = sweep(resnet8_graph(), FLEETS, algs=PAPER_ALGS)
    print_sweep(res, "Fig.2 ResNet8 — normalized rate / latency vs #PUs")
    path = dump("fig2_resnet8", res)
    last = res["fleets"][-1]["algs"]
    first = res["fleets"][0]["algs"]
    for alg in PAPER_ALGS:
        csv_line(f"fig2.resnet8.{alg}.rate_fps@14pu", 0.0,
                 f"{last[alg]['rate_fps']:.1f}")
    csv_line("fig2.resnet8.lblp_vs_wb.rate_ratio@3pu", 0.0,
             f"{first['lblp']['rate_fps']/first['wb']['rate_fps']:.3f}")
    print(f"artifact: {path}")
    return res


if __name__ == "__main__":
    main()
