"""Beyond-paper: elastic rescheduling degradation curve — rate/latency
after successive PU failures, LBLP vs static (no-reschedule) baseline."""

from repro_torch.core import make_pus
from repro_torch.core.elastic import ElasticSession
from repro_torch.models.cnn.graphs import resnet18_graph

from . import common
from .common import csv_line, dump


def main() -> dict:
    g = resnet18_graph()
    sess = ElasticSession(g, make_pus(8, 4), engine=common.SIM_MODE)
    out = {"events": []}
    print("event          n_pus  rate_fps  latency_ms")
    e0 = sess.history[0]
    print(f"initial        {e0.n_pus:5d} {e0.rate:9.0f} {e0.latency*1e3:10.2f}")
    for pid in (2, 4, 7, 1):
        ev = sess.fail(pid)
        out["events"].append({"failed": pid, "n_pus": ev.n_pus,
                              "rate": ev.rate, "latency": ev.latency})
        print(f"fail PU {pid:<6d} {ev.n_pus:5d} {ev.rate:9.0f}"
              f" {ev.latency*1e3:10.2f}")
        csv_line(f"elastic.rate_after_{ev.n_pus}pus", 0.0, f"{ev.rate:.0f}")
    retained = out["events"][-1]["rate"] / e0.rate
    print(f"rate retained after losing 4/12 PUs: {retained*100:.0f}% "
          f"(proportional share would be {8/12*100:.0f}%)")
    out["retained_fraction"] = retained
    path = dump("elastic_bench", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
