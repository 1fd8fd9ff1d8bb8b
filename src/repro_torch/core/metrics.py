"""Derived metrics and normalization helpers (paper §V).

The paper reports *Normalized Processing Rate* (measured rates divided by
their maximum across the compared configurations) and *Normalized
Latency* (latencies divided by their minimum).  These helpers normalize
collections of ``SimResult``s the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

from .simulator import SimResult


@dataclass
class NormalizedPoint:
    key: str                 # e.g. algorithm name or (alg, n_pus) label
    rate: float              # absolute frames/s
    latency: float           # absolute seconds
    norm_rate: float         # rate / max(rate over the group)
    norm_latency: float      # latency / min(latency over the group)
    mean_utilization: float


def normalize(group: Mapping[str, SimResult]) -> Dict[str, NormalizedPoint]:
    """Normalize a group of results per the paper's definition."""
    if not group:
        return {}
    max_rate = max(r.rate for r in group.values())
    min_lat = min(r.latency for r in group.values())
    out = {}
    for k, r in group.items():
        out[k] = NormalizedPoint(
            key=k,
            rate=r.rate,
            latency=r.latency,
            norm_rate=r.rate / max_rate if max_rate > 0 else 0.0,
            norm_latency=r.latency / min_lat if min_lat > 0 else 0.0,
            mean_utilization=r.mean_utilization,
        )
    return out


def utilization_table(result: SimResult) -> str:
    rows = ["pu_id  busy_s       utilization"]
    for pid in sorted(result.utilization):
        rows.append(
            f"{pid:<6d} {result.busy[pid]:<12.6f} {result.utilization[pid]*100:6.1f}%"
        )
    rows.append(f"mean utilization: {result.mean_utilization*100:.1f}%")
    return "\n".join(rows)
