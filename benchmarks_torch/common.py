"""Shared benchmark utilities: experiment runners + artifact dumping.

Counterpart of ``benchmarks.common``, over ``repro_torch.core``.  All
suites take their simulator from :func:`make_sim`, which honors the
module-level ``SIM_MODE``: ``"periodic"`` by default (the compiled
quantized loop with steady-state early exit — see
``repro_torch.core.simulator``), overridable to ``"exact"`` or
``"reference"`` via the ``REPRO_SIM_MODE`` environment variable or by
assignment.  Artifacts go to ``artifacts/bench_torch/``, never to the
reference's ``artifacts/bench/``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Tuple

from repro_torch.core import (CostModel, get_scheduler, make_pus,
                              make_simulator, normalize)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                            "bench_torch")

PAPER_ALGS = ("lblp", "wb", "rr", "rd")
EXTRA_ALGS = ("lblp-x", "heft", "cpop")

#: simulation engine used by every suite ("periodic" | "exact" | "reference")
SIM_MODE = os.environ.get("REPRO_SIM_MODE", "periodic")


def make_sim(graph, cm: CostModel | None = None):
    """Simulator over ``graph`` on the suite-wide ``SIM_MODE`` engine."""
    return make_simulator(graph, cm, engine=SIM_MODE)


def sweep(graph, fleets: Iterable[Tuple[int, int]], algs=PAPER_ALGS,
          frames: int = 96) -> Dict:
    """Run ``algs`` over PU fleets; returns nested result dict."""
    cm = CostModel()
    sim = make_sim(graph, cm)
    out: Dict = {"graph": graph.name, "fleets": []}
    for n_imc, n_dpu in fleets:
        fleet = make_pus(n_imc, n_dpu)
        cell = {"n_imc": n_imc, "n_dpu": n_dpu, "algs": {}}
        group = {}
        for alg in algs:
            t0 = time.perf_counter()
            a = get_scheduler(alg, cm).schedule(graph, fleet)
            sched_us = (time.perf_counter() - t0) * 1e6
            r = sim.run(a, frames=frames)
            group[alg] = r
            cell["algs"][alg] = {
                "rate_fps": r.rate,
                "latency_s": r.latency,
                "latency_isolated_s": r.latency_isolated,
                "interval_s": r.interval,
                "mean_utilization": r.mean_utilization,
                "utilization": {str(k): v for k, v in r.utilization.items()},
                "schedule_time_us": sched_us,
            }
        for alg, pt in normalize(group).items():
            cell["algs"][alg]["norm_rate"] = pt.norm_rate
            cell["algs"][alg]["norm_latency"] = pt.norm_latency
        out["fleets"].append(cell)
    return out


def print_sweep(res: Dict, title: str) -> None:
    print(f"\n== {title} ==")
    algs = list(res["fleets"][0]["algs"])
    hdr = "PUs(imc+dpu) " + "  ".join(f"{a:>22s}" for a in algs)
    print(hdr)
    print(" " * 13 + "  ".join(f"{'nrate / nlat':>22s}" for _ in algs))
    for cell in res["fleets"]:
        label = f"{cell['n_imc']+cell['n_dpu']:3d} ({cell['n_imc']}+{cell['n_dpu']})"
        row = []
        for a in algs:
            d = cell["algs"][a]
            row.append(f"{d['norm_rate']:10.3f} / {d['norm_latency']:8.3f}")
        print(f"{label:<13s}" + "  ".join(f"{r:>22s}" for r in row))


def dump(name: str, payload: Dict) -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return os.path.abspath(path)


def csv_line(name: str, us_per_call: float, derived: str) -> None:
    """Harness convention: ``name,us_per_call,derived``."""
    print(f"CSV,{name},{us_per_call:.3f},{derived}")
