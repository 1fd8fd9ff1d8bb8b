"""Roofline analysis from the dry-run artifacts, with H100 constants.

Counterpart of ``repro.launch.roofline``, with its arithmetic.  Per
(arch x shape) on the single-pod mesh, the three terms are:

    compute    = FLOPs_per_device           / PEAK_FLOPS   (989e12 bf16)
    memory     = bytes_per_device           / HBM_BW       (3.35e12 B/s)
    collective = collective_bytes_per_dev   / (NVLINK_LINK_BW * NVLINK_LINKS)

The constants are one H100 SXM's, from NVIDIA's data sheet (dense, at
the 700 W limit): bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4 as
18 links of 25 GB/s per direction (450 GB/s each way).  That single
link rate assumes every peer of a collective sits on the same NVLink
domain.  It does not hold for the production mesh: an HGX node has 8
cards, so a 16-wide model axis spans two nodes and its collectives cross
the slower inter-node network, which this term does not model.

FLOPs, bytes and collective bytes come from the port's dry run
(``launch.dryrun``, ``artifacts/dryrun_torch/``), counted from the local
ops of one rank.  MODEL_FLOPS uses 6*N*D (dense) / 6*N_active*D (MoE) for
training, 2*N(/active)*D for inference, D = tokens processed.  The
utilization column is MODEL_FLOPS / (chips * peak * dominant_term): the
fraction of roofline the step achieves if it runs exactly at its
bottleneck term.  Every figure here is a model estimate under these
constants, not a measurement.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--markdown]
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import Dict, List

from ..configs import SHAPES, all_archs, get_config
from ..models.lm import transformer

PEAK_FLOPS = 989e12          # bf16 / H100 SXM, dense
HBM_BW = 3.35e12             # B/s / card
NVLINK_LINK_BW = 25e9        # B/s / link / direction (NVLink 4)
NVLINK_LINKS = 18            # links per H100 SXM
PEAK_INT8_OPS = 1979e12      # int8 tensor cores, dense
PEAK_F32_FLOPS = 67e12       # f32 on the CUDA cores (no TF32)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def model_flops(arch: str, shape_name: str) -> float:
    """6*N_active*tokens for train, 2*N_active*tokens for inference."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = transformer.param_count(cfg)
    if cfg.n_experts:
        n -= (cfg.n_experts - cfg.top_k) * cfg.n_layers * 3 \
            * cfg.d_model * cfg.d_ff
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.is_encdec():
            tokens = shape.global_batch * (shape.seq_len // cfg.dec_len_ratio)
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.is_encdec():
            tokens = shape.global_batch * (shape.seq_len // cfg.dec_len_ratio)
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


@dataclass
class RooflineRow:
    arch: str
    shape: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0               # bytes of every local op (no
                                        # fusion -> pessimistic bound)
    memory_fused_s: float = 0.0         # analytic fused-traffic model
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_total: float = 0.0
    useful_ratio: float = 0.0           # MODEL_FLOPS / total counted flops
    roofline_fraction: float = 0.0      # model-flops-time / dominant term
    peak_gib: float = 0.0
    note: str = ""


def fused_memory_bytes(arch: str, shape_name: str) -> float:
    """Coarse fused HBM-traffic model per device per step (the dry run's
    byte count sums every op's operands and results, which overcounts
    device-memory traffic by orders of magnitude; this model counts what a
    fused program moves: weight shards per pass, the remat stash, logits,
    and KV/state caches)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    devices = 256
    shards = devices if cfg.fsdp else 16        # TP / FSDP param sharding
    n_params = transformer.param_count(cfg)
    p_local = 2.0 * n_params / shards           # bf16 weight bytes/device
    mb = min(cfg.microbatch, shape.global_batch)
    n_mb = max(shape.global_batch // mb, 1)
    tok_local = mb * shape.seq_len / 16         # per data-shard tokens/mb
    d = cfg.d_model
    L = cfg.n_layers
    if shape.mode == "train":
        weight_passes = 4.0                      # fwd + remat + 2x bwd
        opt = 10.0 * 4.0 * n_params / shards     # f32 p/m/v read+write
        stash = 2.0 * L * tok_local * d * 2.0    # write + read, bf16
        logits = 2.0 * tok_local * cfg.vocab / 16 * 4.0
        act = 8.0 * tok_local * d * 2.0 * L      # block activations r/w
        return n_mb * (weight_passes * p_local + stash + logits + act) + opt
    if shape.mode == "prefill":
        tok_local = shape.global_batch * shape.seq_len / 16
        cache = 2.0 * L * tok_local * cfg.n_kv_heads * cfg.hd * 2.0 / 16
        act = 6.0 * tok_local * d * 2.0 * L / 16
        return p_local + cache + act
    # decode: read all weights + read/write cache
    cache = (2.0 * L * shape.global_batch * shape.seq_len
             * cfg.n_kv_heads * cfg.hd * 2.0) / devices
    return p_local + 2.0 * cache


def analyse(artifact: Dict) -> RooflineRow:
    arch, shape = artifact["arch"], artifact["shape"]
    if artifact["status"] != "ok":
        return RooflineRow(arch, shape, artifact["status"],
                           note=artifact.get("reason",
                                             artifact.get("error", ""))[:80])
    devices = artifact["devices"]
    cost = artifact.get("cost")
    if not cost:
        return RooflineRow(arch, shape, "no-cost")
    flops_dev = cost["flops_per_device"]
    bytes_dev = cost["bytes_per_device"]
    coll_dev = sum(cost["collective_bytes_per_device"].values())
    compute = flops_dev / PEAK_FLOPS
    memory = bytes_dev / HBM_BW
    memory_fused = fused_memory_bytes(arch, shape) / HBM_BW
    collective = coll_dev / (NVLINK_LINK_BW * NVLINK_LINKS)
    # bottleneck judged on the fused-traffic memory estimate (see
    # fused_memory_bytes docstring); the raw per-op bound is also reported
    dominant = max((compute, "compute"), (memory_fused, "memory"),
                   (collective, "collective"))[1]
    dom_t = max(compute, memory_fused, collective)
    mf = model_flops(arch, shape)
    hlo_total = flops_dev * devices
    ideal_t = mf / (devices * PEAK_FLOPS)
    return RooflineRow(
        arch=arch, shape=shape, status="ok",
        compute_s=compute, memory_s=memory, memory_fused_s=memory_fused,
        collective_s=collective,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_total=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0,
        roofline_fraction=ideal_t / dom_t if dom_t else 0.0,
        peak_gib=artifact["memory"]["peak_estimate_bytes"] / 2**30,
    )


def suggest(row: RooflineRow) -> str:
    """One sentence on what would move the dominant term down."""
    if row.status != "ok":
        return ""
    if row.dominant == "compute":
        if row.useful_ratio < 0.5:
            return ("compute-bound with low useful ratio: cut remat "
                    "recompute (policy: save attn outputs) and MoE "
                    "capacity overhead")
        return ("compute-bound near the useful limit: only faster math "
                "(int8/fp8 matmuls) or more chips move this")
    if row.dominant == "memory":
        return ("memory-bound: fuse attention (the flash kernel avoids "
                "logits round-trips), keep KV cache in bf16, widen "
                "per-step arithmetic intensity (larger microbatch)")
    return ("collective-bound: overlap all-reduce with backward compute, "
            "reduce-scatter gradients (FSDP), or INT8-compress "
            "(optim.compression) the gradient traffic")


def load_rows(mesh: str = "pod16x16") -> List[RooflineRow]:
    rows = []
    for arch in all_archs():
        for shape in SHAPES:
            path = os.path.join(ART_DIR, f"{arch}__{shape}__{mesh}.json")
            if not os.path.exists(path):
                rows.append(RooflineRow(arch, shape, "missing"))
                continue
            with open(path) as f:
                rows.append(analyse(json.load(f)))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    rows = load_rows()

    if args.markdown:
        print("| arch | shape | compute s | mem(ops) s | mem(fused) s |"
              " coll s | dominant | useful | roofline | peak GiB | note |")
        print("|---|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if r.status != "ok":
                print(f"| {r.arch} | {r.shape} | - | - | - | - |"
                      f" {r.status} | - | - | - | {r.note} |")
                continue
            print(f"| {r.arch} | {r.shape} | {r.compute_s:.3e} |"
                  f" {r.memory_s:.3e} | {r.memory_fused_s:.3e} |"
                  f" {r.collective_s:.3e} |"
                  f" {r.dominant} | {r.useful_ratio:.2f} |"
                  f" {r.roofline_fraction:.2f} | {r.peak_gib:.1f} |"
                  f" {suggest(r)[:60]} |")
    else:
        hdr = (f"{'arch':24s} {'shape':12s} {'compute':>10s} {'mem(ops)':>10s}"
               f" {'mem(fused)':>10s} {'coll':>10s} {'dom':>10s}"
               f" {'useful':>7s} {'roofl':>6s}")
        print(hdr)
        for r in rows:
            if r.status != "ok":
                print(f"{r.arch:24s} {r.shape:12s} [{r.status}] {r.note}")
                continue
            print(f"{r.arch:24s} {r.shape:12s} {r.compute_s:10.3e}"
                  f" {r.memory_s:10.3e} {r.memory_fused_s:10.3e}"
                  f" {r.collective_s:10.3e}"
                  f" {r.dominant:>10s} {r.useful_ratio:7.2f}"
                  f" {r.roofline_fraction:6.2f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.__dict__ for r in rows], f, indent=2)
        print(f"wrote {args.json_out}")


if __name__ == "__main__":
    main()
