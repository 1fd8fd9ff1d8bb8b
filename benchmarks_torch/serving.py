"""Beyond-paper: SLO-aware serving control plane vs admit-all / static.

Replays seeded tenant-churn traces (arrivals with rate/latency SLOs,
departures, weight changes, a PU failure and rejoin) against three
serving policies over the same fleet:

* **slo-aware** — the full control plane (`repro_torch.core.serving`):
  probe-gated admission, replica reclaim to make room, eviction repair
  after capacity loss, and replica autoscaling onto the hottest tenant.
* **admit-all** — every arrival is admitted and co-scheduled; no
  probes, no replicas.  Over-subscription shows up as SLO violations.
* **static** — the classic ops baseline: the fleet is evenly sliced,
  one tenant per slice (1+ IMC and 1+ DPU each), arrivals beyond the
  slice count are rejected, each tenant is scheduled alone with lblp.

The figure of merit is **goodput**: a tenant's attained rate counts
only at trace ticks where its SLO holds (a broken promise delivers no
value).  Expected outcome, asserted in the artifact: slo-aware meets
every admitted tenant's SLO on every cell (by construction — admission
is probe-gated and repair evicts on capacity loss) and attains at least
admit-all's aggregate goodput on most cells; its decision log is
bit-deterministic per seed.
"""

from __future__ import annotations

import random
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import CostModel, get_scheduler, make_pus, make_simulator
from repro_torch.core.cost import PUSpec
from repro_torch.core.graph import Graph, PUType
from repro_torch.core.serving import (SLO, ServingControlPlane, SLOReport,
                                      TraceEvent, aggregate_goodput)
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph

from . import common
from .common import csv_line, dump

#: (fleet (n_imc, n_dpu), model mix, trace seed) — 8 cells
CELLS = [
    ((4, 2), ("resnet8",), 11),
    ((4, 2), ("resnet8",), 23),
    ((4, 2), ("resnet8", "resnet18"), 11),
    ((4, 2), ("resnet8", "resnet18"), 23),
    ((6, 3), ("resnet8",), 11),
    ((6, 3), ("resnet8",), 23),
    ((6, 3), ("resnet8", "resnet18"), 11),
    ((6, 3), ("resnet8", "resnet18"), 23),
]

ARRIVALS = 6


def solo_profile(models: Dict[str, Graph], fleet_shape: Tuple[int, int],
                 cm: CostModel, frames: int) -> Dict[str, Tuple[float, float]]:
    """Each model's solo full-fleet (rate, latency) — the deterministic
    calibration base the synthetic SLOs are fractions of."""
    out = {}
    fleet = make_pus(*fleet_shape)
    for name, g in models.items():
        a = get_scheduler("lblp", cm).schedule(g, fleet)
        r = make_simulator(g, cm, engine=common.SIM_MODE).run(a, frames=frames)
        out[name] = (r.rate, r.latency)
    return out


def synth_trace(seed: int, mix: Sequence[str],
                solo: Dict[str, Tuple[float, float]],
                fleet_shape: Tuple[int, int]) -> List[TraceEvent]:
    """Deterministic churn trace: ARRIVALS arrivals whose rate demands
    sum well past the fleet's capacity (so admission has something to
    decide), plus a weight change, a departure, and a PU failure that
    later rejoins.  Departure/load targets are drawn from all *arrived*
    names — a policy that rejected the target replays them as no-ops,
    keeping one trace comparable across policies."""
    rng = random.Random(seed)
    n_imc = fleet_shape[0]
    events: List[TraceEvent] = []
    names: List[str] = []
    failed_pu = rng.randrange(1, n_imc + 1)
    for i in range(ARRIVALS):
        model = mix[i % len(mix)]
        rate, lat = solo[model]
        frac = rng.choice([0.2, 0.35, 0.5, 0.75])
        max_lat = lat * rng.choice([50, 150, 400]) if rng.random() < 0.5 \
            else None
        name = f"{model}-{i}"
        names.append(name)
        events.append(TraceEvent(
            "arrive", tenant=name, model=model,
            slo=SLO(min_rate=rate * frac, max_latency=max_lat),
            weight=rng.choice([0.5, 1.0, 1.0, 2.0])))
        if i == 2:
            events.append(TraceEvent("fail", pu_id=failed_pu))
        if i == 3:
            events.append(TraceEvent("load", tenant=rng.choice(names),
                                     weight=rng.choice([0.5, 2.0])))
        if i == 4:
            events.append(TraceEvent("depart", tenant=rng.choice(names)))
            events.append(TraceEvent("join", pu_id=failed_pu,
                                     pu_type="imc"))
    return events


class StaticPartitionPlane:
    """Static-slicing baseline with the same trace/report interface as
    :class:`ServingControlPlane`: round-robin even fleet slices, one
    resident tenant per slice, admission = "a slice is free", repair =
    evict newest residents until the shrunken fleet slices again."""

    def __init__(self, pus: Sequence[PUSpec], models: Dict[str, Graph],
                 cost_model: Optional[CostModel] = None,
                 engine: str = "periodic", frames: int = 64) -> None:
        self.live: List[PUSpec] = list(pus)
        self.models = models
        self.cm = cost_model or CostModel()
        self.engine = engine
        self.frames = frames
        self.residents: List[Tuple[str, str]] = []   # (tenant, model)
        self.slos: Dict[str, SLO] = {}
        self.reports: Dict[str, SLOReport] = {}
        self.n_events = 0

    def _slices(self, n: int) -> Optional[List[List[PUSpec]]]:
        imc = [p for p in self.live if p.pu_type is PUType.IMC]
        dpu = [p for p in self.live if p.pu_type is PUType.DPU]
        if n == 0:
            return []
        if len(imc) < n or len(dpu) < n:
            return None
        return [imc[k::n] + dpu[k::n] for k in range(n)]

    def play(self, trace: Sequence[TraceEvent]) -> None:
        for ev in trace:
            self.step(ev)

    def step(self, ev: TraceEvent) -> None:
        index = self.n_events
        self.n_events += 1
        if ev.kind == "arrive":
            rep = self.reports[ev.tenant] = SLOReport(
                tenant=ev.tenant, slo=ev.slo, weight=ev.weight)
            if self._slices(len(self.residents) + 1) is None:
                rep.rejected_index = index
            else:
                self.residents.append((ev.tenant, ev.model))
                self.slos[ev.tenant] = ev.slo
                rep.admitted_index = index
        elif ev.kind == "depart" and ev.tenant in self.slos:
            self.residents = [r for r in self.residents
                              if r[0] != ev.tenant]
            self.slos.pop(ev.tenant)
            self.reports[ev.tenant].departed_index = index
        elif ev.kind == "load" and ev.tenant in self.slos:
            self.reports[ev.tenant].weight = ev.weight
        elif ev.kind == "fail":
            self.live = [p for p in self.live if p.pu_id != ev.pu_id]
            while self.residents and self._slices(len(self.residents)) is None:
                t, _ = self.residents.pop()       # evict newest
                self.slos.pop(t)
                self.reports[t].evicted_index = index
        elif ev.kind == "join":
            self.live.append(PUSpec(pu_id=ev.pu_id,
                                    pu_type=PUType(ev.pu_type),
                                    speed=ev.speed))
        self._sample(index)

    def _sample(self, index: int) -> None:
        slices = self._slices(len(self.residents))
        if not slices:
            return
        for (tenant, model), sl in zip(self.residents, slices):
            g = self.models[model]
            a = get_scheduler("lblp", self.cm).schedule(g, sl)
            r = make_simulator(g, self.cm, engine=self.engine).run(
                a, frames=self.frames)
            h = self.slos[tenant].headroom(r.rate, r.latency)
            self.reports[tenant].samples.append(
                (index, r.rate, r.latency, h))


def run_cell(fleet_shape, mix, seed, models, cm, frames) -> dict:
    solo = solo_profile({m: models[m] for m in mix}, fleet_shape, cm, frames)
    trace = synth_trace(seed, mix, solo, fleet_shape)

    def fresh(admission: bool, autoscale: bool) -> ServingControlPlane:
        return ServingControlPlane(
            make_pus(*fleet_shape), models, cost_model=cm,
            engine=common.SIM_MODE, frames=frames,
            admission=admission, autoscale=autoscale)

    aware = fresh(True, True)
    aware.play(trace)
    admit_all = fresh(False, False)
    admit_all.play(trace)
    static = StaticPartitionPlane(make_pus(*fleet_shape), models,
                                  cost_model=cm, engine=common.SIM_MODE,
                                  frames=frames)
    static.play(trace)

    # determinism: an identically configured replay of the same trace
    # must produce a bit-identical audit artifact
    replay = fresh(True, True)
    replay.play(trace)
    deterministic = replay.audit_json() == aware.audit_json()

    def summarize(reports, n_events, plane=None) -> dict:
        _, mean = aggregate_goodput(reports, n_events)
        admitted = [r for r in reports.values()
                    if r.admitted_index is not None]
        return {
            "goodput": mean,
            "admitted": len(admitted),
            "rejected": sum(1 for r in reports.values()
                            if r.rejected_index is not None),
            "evicted": sum(1 for r in reports.values()
                           if r.evicted_index is not None),
            "violation_ticks": sum(
                len(range(v[0], v[1] + 1))
                for r in reports.values() for v in r.violations),
            "all_admitted_slos_met": all(r.satisfied() for r in admitted),
            **({"decisions": len(plane.decisions),
                "probes": plane.probes} if plane is not None else {}),
        }

    return {
        "n_imc": fleet_shape[0], "n_dpu": fleet_shape[1],
        "mix": "+".join(mix), "seed": seed,
        "events": len(trace),
        "deterministic": deterministic,
        "slo_aware": summarize(aware.reports, aware.n_events, aware),
        "admit_all": summarize(admit_all.reports, admit_all.n_events),
        "static": summarize(static.reports, static.n_events),
    }


def main(frames: int = 96) -> dict:
    cm = CostModel()
    # one graph object per model (a registry): every plane, probe and
    # baseline over the same model shares compiled contexts and memos
    models = {"resnet8": resnet8_graph(), "resnet18": resnet18_graph()}
    out = {"frames": frames, "cells": []}
    print(f"{'cell':<24s} {'policy':>10s} {'goodput':>9s} {'adm':>4s} "
          f"{'rej':>4s} {'evi':>4s} {'viol':>5s} {'slos_met':>8s}")
    for fleet_shape, mix, seed in CELLS:
        cell = run_cell(fleet_shape, mix, seed, models, cm, frames)
        out["cells"].append(cell)
        label = (f"{cell['mix']} {cell['n_imc']}+{cell['n_dpu']} "
                 f"s{cell['seed']}")
        for policy in ("slo_aware", "admit_all", "static"):
            s = cell[policy]
            print(f"{label:<24s} {policy:>10s} {s['goodput']:9.0f} "
                  f"{s['admitted']:4d} {s['rejected']:4d} {s['evicted']:4d} "
                  f"{s['violation_ticks']:5d} "
                  f"{str(s['all_admitted_slos_met']):>8s}")
            label = ""
        csv_line(
            f"serving.{cell['mix'].replace('+', '_')}"
            f".{cell['n_imc']}+{cell['n_dpu']}.s{cell['seed']}",
            0.0,
            f"{cell['slo_aware']['goodput'] / max(cell['admit_all']['goodput'], 1e-9):.3f}")

    cells = out["cells"]
    met_all = sum(1 for c in cells if c["slo_aware"]["all_admitted_slos_met"])
    beats = sum(1 for c in cells
                if c["slo_aware"]["goodput"]
                >= c["admit_all"]["goodput"] * (1 - 1e-9))
    beats_static = sum(1 for c in cells
                       if c["slo_aware"]["goodput"]
                       >= c["static"]["goodput"] * (1 - 1e-9))
    det = sum(1 for c in cells if c["deterministic"])
    out["cells_slos_met"] = met_all
    out["cells_geq_admit_all"] = beats
    out["cells_geq_static"] = beats_static
    out["cells_deterministic"] = det
    print(f"\nslo-aware meets every admitted SLO on {met_all}/{len(cells)} "
          f"cells; goodput >= admit-all on {beats}/{len(cells)}, "
          f">= static on {beats_static}/{len(cells)}; "
          f"deterministic replay on {det}/{len(cells)}")
    path = dump("serving", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    kw = {}
    if "--frames" in sys.argv:
        kw["frames"] = int(sys.argv[sys.argv.index("--frames") + 1])
    main(**kw)
