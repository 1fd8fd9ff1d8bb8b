"""Paper Fig. 3 — ResNet18: normalized processing rate & latency vs #PUs
for LBLP / WB / RR / RD."""

from repro_torch.models.cnn.graphs import resnet18_graph

from .common import PAPER_ALGS, csv_line, dump, print_sweep, sweep

# ~2:1 IMC:DPU (Table I uses 8+4 at 12 total); top out at 30 (= #nodes)
FLEETS = [(2, 1), (4, 2), (6, 3), (8, 4), (10, 5), (14, 7), (21, 9)]


def main() -> dict:
    res = sweep(resnet18_graph(), FLEETS, algs=PAPER_ALGS, frames=128)
    print_sweep(res, "Fig.3 ResNet18 — normalized rate / latency vs #PUs")
    path = dump("fig3_resnet18", res)
    cell12 = next(c for c in res["fleets"] if c["n_imc"] + c["n_dpu"] == 12)
    ratio_rate = cell12["algs"]["lblp"]["rate_fps"] / cell12["algs"]["wb"]["rate_fps"]
    ratio_lat = cell12["algs"]["wb"]["latency_s"] / cell12["algs"]["lblp"]["latency_s"]
    csv_line("fig3.resnet18.lblp_vs_wb.rate_ratio@12pu", 0.0, f"{ratio_rate:.3f}")
    csv_line("fig3.resnet18.wb_vs_lblp.latency_ratio@12pu", 0.0, f"{ratio_lat:.3f}")
    print(f"paper check: rate ratio {ratio_rate:.2f} (paper >2), "
          f"latency ratio {ratio_lat:.2f} (paper ~1.4)")
    print(f"artifact: {path}")
    return res


if __name__ == "__main__":
    main()
