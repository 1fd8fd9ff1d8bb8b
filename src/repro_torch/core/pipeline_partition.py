"""LBLP as a transformer pipeline-stage partitioner (the paper's
technique as a first-class LM-tier feature); the port's counterpart of
``repro.core.pipeline_partition``.

A transformer is lowered to a deployment Graph whose nodes are layer
blocks (attention / MoE / SSM / recurrent / embed / head), with FLOPs-
derived costs per node.  The stage fleet is modelled as homogeneous
"IMC" PUs (every stage is one H100 that runs every block kind), and LBLP's
load-balance-longest-path policy assigns blocks to stages.  For dense
stacks this reduces to balanced contiguous chunking; for MoE / hybrid
stacks the heterogeneous per-block costs make the balance non-trivial —
exactly the regime the paper targets.

Contiguity: pipeline stages must hold *contiguous* layer ranges (a
transformer layer chain is sequential).  LBLP's mapping is therefore
projected to the nearest contiguous partition preserving per-stage load
ordering — the classic "chain partitioning" projection; the quality gap
vs unrestricted LBLP is reported so the effect is visible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..configs.base import LMConfig

from .cost import CostModel, PUSpec
from .graph import Graph, OpKind, PUType
from .schedulers import get_scheduler


def transformer_block_graph(cfg: LMConfig, seq_len: int) -> Graph:
    """Layer-block DAG with per-block FLOPs (forward, per token batch of 1
    sequence of ``seq_len``)."""
    g = Graph(f"{cfg.name}-blocks")
    d, s = cfg.d_model, seq_len
    embed = g.add("embed", OpKind.EMBED, flops=2.0 * s * d,
                  weight_bytes=cfg.vocab * d, out_bytes=s * d,
                  out_elems=s * d)
    prev = embed.node_id

    def attn_flops() -> float:
        hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        proj = 2.0 * s * d * (H * hd + 2 * KV * hd + H * hd)
        qk_av = 2.0 * 2.0 * s * s * H * hd
        return proj + qk_av

    def ffn_flops() -> float:
        if cfg.n_experts:
            return 2.0 * 3 * s * cfg.top_k * d * cfg.d_ff
        mats = 2 if cfg.mlp_kind == "plain" else 3
        return 2.0 * mats * s * d * cfg.d_ff

    def rec_flops() -> float:
        di = cfg.d_inner or d
        return 2.0 * s * (2 * d * di + 2 * di * di) + 10.0 * s * di

    def ssm_flops() -> float:
        di = cfg.d_inner or 2 * d
        n = cfg.ssm_state or 16
        return 2.0 * s * (2 * d * di + di * cfg.dt_rank * 2
                          + di * 2 * n) + 12.0 * s * di * n

    li = 0
    for seg in cfg.segments:
        kinds: List[str]
        if seg.kind == "hybrid3":
            kinds = ["rec", "rec", "attn"] * seg.n
        else:
            kinds = [seg.kind] * seg.n
        for kind in kinds:
            if kind in ("attn", "xattn"):
                fl = attn_flops() + ffn_flops()
                wb = 4 * d * cfg.hd * cfg.n_heads + (
                    cfg.n_experts * 3 * d * cfg.d_ff if cfg.n_experts
                    else 3 * d * cfg.d_ff)
                op = OpKind.MOE if cfg.n_experts else OpKind.ATTENTION
            elif kind == "ssm":
                fl, wb, op = ssm_flops(), 3 * d * (cfg.d_inner or d), \
                    OpKind.RECURRENT
            else:  # rec
                fl = rec_flops() + ffn_flops()
                wb = 4 * d * (cfg.d_inner or d) + 3 * d * cfg.d_ff
                op = OpKind.RECURRENT
            node = g.add(f"L{li}.{kind}", op, deps=[prev], flops=fl,
                         weight_bytes=float(wb), out_bytes=float(s * d),
                         out_elems=float(s * d),
                         meta={"layer": li, "kind": kind})
            prev = node.node_id
            li += 1
    g.add("head", OpKind.MVM, deps=[prev], flops=2.0 * s * d * cfg.vocab,
          weight_bytes=float(d * cfg.vocab), out_bytes=float(s * cfg.vocab),
          out_elems=float(s * cfg.vocab),
          meta={"cin_kk": d, "cout": cfg.vocab, "n_vectors": s})
    g.validate()
    return g


@dataclass
class StagePlan:
    stage_of: Dict[int, int]            # node_id -> stage
    boundaries: List[int]               # layer indices starting each stage
    loads: List[float]                  # per-stage time [s]
    imbalance: float                    # max/mean load
    lblp_bottleneck: float              # unrestricted-LBLP bound (reference)


#: dense bf16 tensor-core peak of one NVIDIA H100 SXM [FLOP/s], the rate
#: of every stage.  Only the loads scale with it: which block lands in
#: which stage does not depend on it.
STAGE_PEAK_FLOPS = 989e12


def _flops_cost_model() -> CostModel:
    """Homogeneous H100 stages: time ~ flops / STAGE_PEAK_FLOPS."""

    class FlopsCM(CostModel):
        def _time_uncached(self, node, pu_type):
            return node.flops / STAGE_PEAK_FLOPS

    return FlopsCM()


def partition(cfg: LMConfig, n_stages: int, seq_len: int = 4096
              ) -> StagePlan:
    g = transformer_block_graph(cfg, seq_len)
    cm = _flops_cost_model()
    # homogeneous stage fleet: model every stage as an IMC-class PU with
    # infinite weight capacity (HBM modeled separately)
    pus = [PUSpec(pu_id=i + 1, pu_type=PUType.IMC, weight_capacity=float("inf"))
           for i in range(n_stages)]
    for n in g.nodes.values():
        n.pu_type = PUType.IMC           # every block runs on an H100 stage
    a = get_scheduler("lblp", cm).schedule(g, pus)
    lblp_bneck = a.bottleneck(g, cm)

    # ---- contiguity projection (chain partitioning) ---------------------
    order = g.topo_order()
    costs = [cm.time(g.nodes[n]) for n in order]
    total = sum(costs)
    target = total / n_stages
    boundaries = [0]
    acc = 0.0
    stage_of: Dict[int, int] = {}
    stage = 0
    loads = [0.0] * n_stages
    for i, (nid, c) in enumerate(zip(order, costs)):
        if acc + c / 2.0 > target * (stage + 1) and stage < n_stages - 1:
            stage += 1
            boundaries.append(i)
        stage_of[nid] = stage
        loads[stage] += c
        acc += c
    mean = total / n_stages
    return StagePlan(
        stage_of=stage_of,
        boundaries=boundaries,
        loads=loads,
        imbalance=max(loads) / mean if mean else 1.0,
        lblp_bottleneck=lblp_bneck,
    )
