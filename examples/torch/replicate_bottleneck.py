"""Replicate the bottleneck layer: graph -> lblp-r -> simulate.

Walks the LRMP-style replication flow end to end: schedule ResNet-8 with
plain LBLP, inspect the bottleneck PU, then let lblp-r greedily clone the
longest-path bottleneck nodes into spare PU capacity (round-robin frame
splitting) and compare processing rate before/after.

    PYTHONPATH=src python examples/torch/replicate_bottleneck.py
"""

from repro_torch.core import CostModel, IMCESimulator, get_scheduler, make_pus, schedule_replicated
from repro_torch.models.cnn.graphs import resnet8_graph


def main() -> None:
    graph = resnet8_graph()
    cm = CostModel()
    fleet = make_pus(n_imc=12, n_dpu=6)  # spare capacity to replicate into

    # 1. plain LBLP: the bound is one heavy layer no placement can split
    base = get_scheduler("lblp", cm).schedule(graph, fleet)
    base_r = IMCESimulator(graph, cm).run(base, frames=96)
    load = base.load(graph, cm)
    bottleneck = max(load, key=load.get)
    print(
        f"lblp: rate {base_r.rate:.0f} fps, "
        f"bound {base_r.bound_interval*1e6:.0f} us "
        f"(PU {bottleneck} holds {base.nodes_on(bottleneck)})"
    )

    # 2. lblp-r: clone bottleneck nodes until the balance gain flattens
    g_r, repl = schedule_replicated(graph, fleet, cm)
    print(f"lblp-r replicas (base node -> count): {repl.meta['replicas']}")
    for base_id, members in sorted(g_r.replica_groups().items()):
        names = [g_r.nodes[m].name for m in members]
        print(f"  node {base_id}: {names}")

    # 3. simulate the replicated graph: frame f runs on replica f % k
    repl_r = IMCESimulator(g_r, cm).run(repl, frames=96)
    print(
        f"lblp-r: rate {repl_r.rate:.0f} fps, "
        f"bound {repl_r.bound_interval*1e6:.0f} us "
        f"({repl_r.rate / base_r.rate:.2f}x lblp)"
    )


if __name__ == "__main__":
    main()
