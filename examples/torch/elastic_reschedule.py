"""Elastic scaling demo: PUs die one by one, LBLP re-places the network
each time, and the processing rate degrades gracefully; a replacement PU
joins and the rate recovers.

    PYTHONPATH=src python examples/torch/elastic_reschedule.py
"""

from repro_torch.core import PUSpec, PUType, make_pus
from repro_torch.core.elastic import ElasticSession
from repro_torch.models.cnn.graphs import resnet18_graph


def main() -> None:
    sess = ElasticSession(resnet18_graph(), make_pus(8, 4))
    ev0 = sess.history[0]
    print(f"initial: {ev0.n_pus} PUs rate={ev0.rate:.0f} fps "
          f"latency={ev0.latency*1e3:.2f} ms")

    for pid in (2, 7, 5):
        ev = sess.fail(pid)
        print(f"PU {pid} died -> reschedule: {ev.n_pus} PUs "
              f"rate={ev.rate:.0f} fps latency={ev.latency*1e3:.2f} ms")

    ev = sess.join(PUSpec(pu_id=20, pu_type=PUType.IMC))
    print(f"spare IMC PU joined -> {ev.n_pus} PUs rate={ev.rate:.0f} fps")

    print("\ndegradation curve (n_pus, rate, latency_ms):")
    for n, r, lat in sess.degradation_curve():
        print(f"  {n:3d}  {r:8.0f}  {lat*1e3:8.2f}")


if __name__ == "__main__":
    main()
