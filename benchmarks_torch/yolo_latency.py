"""Paper §V.C — YOLOv8n: LBLP-vs-WB latency gap.

The paper: the subset is mostly sequential, parallel branches bound the
schedulable-parallelism effect to ~10% of latency; they measured up to a
6% latency difference.  We report the isolated-inference gap (pure
branch-parallelism effect, <=10% bound) and the streaming sojourn gap
(queueing included), which bracket the paper's protocol."""

from repro_torch.core import CostModel, get_scheduler, make_pus
from repro_torch.models.cnn.graphs import yolov8n_graph

from .common import csv_line, dump, make_sim

FLEETS = [(8, 4), (12, 6), (16, 8), (24, 12)]


def main() -> dict:
    g = yolov8n_graph()
    cm = CostModel()
    sim = make_sim(g, cm)
    crit = g.critical_time(lambda n: cm.time(n))
    total = sum(cm.time(n) for n in g.nodes.values() if not n.is_free())
    out = {"off_path_share": (total - crit) / total, "fleets": []}
    print("== YOLOv8n LBLP vs WB ==")
    print(f"off-critical-path work: {out['off_path_share']*100:.1f}% of total "
          "(paper: parallelism affects at most ~10% of latency)")
    print("PUs   isolated-gap%  streaming-gap%  rate lblp/wb")
    for n_imc, n_dpu in FLEETS:
        fleet = make_pus(n_imc, n_dpu)
        res = {}
        for alg in ("lblp", "wb"):
            a = get_scheduler(alg, cm).schedule(g, fleet)
            res[alg] = sim.run(a, frames=48)
        iso = abs(res["wb"].latency_isolated - res["lblp"].latency_isolated) \
            / min(r.latency_isolated for r in res.values())
        strm = abs(res["wb"].latency - res["lblp"].latency) \
            / min(r.latency for r in res.values())
        rr = res["lblp"].rate / res["wb"].rate
        out["fleets"].append({
            "n_imc": n_imc, "n_dpu": n_dpu, "isolated_gap": iso,
            "streaming_gap": strm, "rate_ratio": rr,
        })
        print(f"{n_imc+n_dpu:3d}   {iso*100:11.2f}  {strm*100:13.2f}  {rr:10.2f}")
        csv_line(f"yolo.latency_gap_isolated.pu{n_imc+n_dpu}", 0.0,
                 f"{iso*100:.2f}%")
    print("paper: measured gap up to 6%")
    path = dump("yolo_latency", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
