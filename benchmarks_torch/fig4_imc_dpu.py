"""Paper Fig. 4 — ResNet18 at a fixed 12-PU budget: rate & latency for
different IMC/DPU splits (chip-area allocation study), LBLP vs WB."""

from repro_torch.models.cnn.graphs import resnet18_graph

from .common import csv_line, dump, print_sweep, sweep

TOTAL = 12
FLEETS = [(TOTAL - d, d) for d in (2, 3, 4, 6, 8)]


def main() -> dict:
    res = sweep(resnet18_graph(), FLEETS, algs=("lblp", "wb"), frames=128)
    print_sweep(res, "Fig.4 ResNet18 — fixed 12 PUs, varying #DPUs")
    for cell in res["fleets"]:
        d = cell["n_dpu"]
        ratio = cell["algs"]["lblp"]["rate_fps"] / cell["algs"]["wb"]["rate_fps"]
        csv_line(f"fig4.rate_ratio.dpu{d}", 0.0, f"{ratio:.3f}")
    path = dump("fig4_imc_dpu", res)
    print(f"artifact: {path}")
    return res


if __name__ == "__main__":
    main()
