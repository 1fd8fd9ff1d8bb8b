"""Beyond-paper: the paper's technique on the LM tier — LBLP-driven
pipeline-stage partitioning of the 10 assigned architectures vs naive
uniform layer chunking.

For heterogeneous stacks (MoE routers vs experts, RG-LRU vs attention
blocks, enc vs dec) uniform chunking mis-balances stages; LBLP's
load-balance objective (projected to contiguous stages) recovers the
balance.  Reported: per-stage load imbalance (max/mean) for both."""

from repro_torch.configs import all_archs, get_config
from repro_torch.core.pipeline_partition import partition, transformer_block_graph

from .common import csv_line, dump


def uniform_imbalance(cfg, n_stages: int, seq_len: int = 4096) -> float:
    g = transformer_block_graph(cfg, seq_len)
    order = g.topo_order()
    from repro_torch.core.pipeline_partition import _flops_cost_model
    cm = _flops_cost_model()
    costs = [cm.time(g.nodes[n]) for n in order]
    per = len(order) // n_stages
    loads = []
    for s in range(n_stages):
        lo = s * per
        hi = (s + 1) * per if s < n_stages - 1 else len(order)
        loads.append(sum(costs[lo:hi]))
    mean = sum(loads) / n_stages
    return max(loads) / mean if mean else 1.0


def main() -> dict:
    out = {}
    n_stages = 8
    print(f"pipeline partitioning into {n_stages} stages (imbalance = "
          "max stage load / mean)")
    print(f"{'arch':24s} {'uniform':>9s} {'lblp':>9s}  winner")
    for arch in all_archs():
        cfg = get_config(arch)
        u = uniform_imbalance(cfg, n_stages)
        plan = partition(cfg, n_stages)
        winner = "lblp" if plan.imbalance < u - 1e-9 else (
            "tie" if abs(plan.imbalance - u) <= 1e-9 else "uniform")
        out[arch] = {"uniform": u, "lblp": plan.imbalance, "winner": winner}
        print(f"{arch:24s} {u:9.3f} {plan.imbalance:9.3f}  {winner}")
        csv_line(f"partition.{arch}", 0.0,
                 f"uniform={u:.3f},lblp={plan.imbalance:.3f}")
    wins = sum(1 for v in out.values() if v["winner"] == "lblp")
    print(f"\nLBLP strictly better on {wins}/{len(out)} archs "
          "(ties occur on perfectly homogeneous dense stacks)")
    path = dump("lm_partition", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    main()
