"""Simulator throughput benchmark: the port's perf trajectory.

Counterpart of ``benchmarks.sim_speed``.  Measures the port's compiled
event loop (``repro_torch.core.simulator``) against its frozen
pre-compilation loop (``repro_torch.core._sim_reference``) on the
reference's workloads:

* the **YOLOv8n 256-frame cell** (233 nodes, lblp on an 8+4 fleet,
  full ``run()``) — reference vs compiled-exact vs periodic early-exit,
  plus raw event-loop events/sec;
* a **multi-tenant cell** (2x ResNet-8 + ResNet-18 co-scheduled with
  lblp-mt on an 8+4 fleet) — the multi-stream early-exit trajectory
  point;
* the **simulator-driven suites of ``benchmarks_torch.run`` at
  ``--frames 64``** — every suite whose wall-clock the event loop
  determines, run twice with the suite-wide engine toggled
  (``benchmarks_torch.common.SIM_MODE``) between ``"reference"`` and the
  current default.  The ``kernels`` (the card) and ``partition`` (no
  simulator) suites are excluded: their wall-clock is independent of
  the loop.

Writes its own baseline, ``BENCH_sim_torch.json``, at the repo root (the
port's perf-trajectory record) and the usual artifact under
``artifacts/bench_torch/``.  It never writes ``BENCH_sim.json``, the
reference's record, which the reference's perf gate reads.

The port times the suites in rounds, each suite once a round under each
engine in turn, with the garbage collector held off during each run
(``ref_s``/``new_s`` are the fastest runs; ``speedup`` is the median of
the suite's paired ratios), ``SUITE_REPEATS`` rounds for the gate and
``BASELINE_ROUNDS`` for a baseline, where the reference times each
engine back to back, best of 3 for the gate and of 2 for a baseline: on
the shared hosts the port runs on, one such measurement swings by more
than the gate's slack.

Perf gate: ``python -m benchmarks_torch.sim_speed --check
BENCH_sim_torch.json``
re-measures and fails (exit 1) when any suite's reference-vs-default
speedup regressed more than ``CHECK_SLACK`` against the committed
baseline.  Speedup ratios — not absolute seconds — are compared, so the
gate is robust to CI runner speed.
"""

from __future__ import annotations

import gc
import importlib
import inspect
import io
import json
import os
import platform
import statistics
import sys
import time
from contextlib import redirect_stdout

from repro_torch.core import CostModel, MultiTenantGraph, get_scheduler, make_pus, make_simulator
from repro_torch.models.cnn.graphs import resnet8_graph, resnet18_graph, yolov8n_graph

from . import common
from .common import csv_line, dump

#: benchmarks_torch.run suites whose wall-clock the simulator determines
SIM_SUITES = (
    "fig2",
    "fig3",
    "table1",
    "fig4",
    "yolo",
    "quality",
    "elastic",
    "multi_tenant",
    "replication",
    "sensitivity",
)

ROOT_JSON = os.path.join(os.path.dirname(__file__), "..",
                         "BENCH_sim_torch.json")

#: allowed per-suite speedup regression before --check fails
CHECK_SLACK = 0.25

#: rounds of paired runs when --check re-measures (the reference takes 3
#: runs of each engine back to back), and when a baseline is written
#: (``BASELINE_ROUNDS``; the reference takes 2): a shared host's speed
#: can swing by 2x over minutes (the event loop read 404k and 893k
#: events/s minutes apart on the 8-vCPU host of an H100 machine) and
#: stall for seconds, which moves one measurement's ratios by more than
#: the slack (with 5 rounds a gate there still re-measured in 3 of 5)
SUITE_REPEATS = 9
BASELINE_ROUNDS = 15

#: the reference's anchor, kept as it is: its PR 3 reference-engine suite
#: times, in seconds on the reference's own machine (not this port's, nor
#: the host this runs on), so ``speedup_vs_pr3_ref`` compares across
#: machines and reads only as a trajectory mark
PR3_REF_S = {
    "fig2": 0.7275,
    "fig3": 2.8692,
    "table1": 0.1913,
    "fig4": 1.0751,
    "yolo": 2.3114,
    "quality": 0.8195,
    "elastic": 0.1527,
    "multi_tenant": 1.5128,
    "replication": 0.7999,
    "sensitivity": 2.0891,
}


def _best(fn, repeats: int = 2) -> float:
    out = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        out = min(out, time.perf_counter() - t0)
    return out


def _timed(fn) -> float:
    """Seconds of one ``fn()``, with the garbage collector run before and
    held off during it, as ``timeit`` times: a collection of the heap the
    suites leave behind otherwise lands on whichever run it falls in."""
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    finally:
        gc.enable()


def yolo_cell(frames: int) -> dict:
    g = yolov8n_graph()
    cm = CostModel()
    a = get_scheduler("lblp", cm).schedule(g, make_pus(8, 4))
    sims = {
        "reference": make_simulator(g, cm, engine="reference"),
        "exact": make_simulator(g, cm, engine="exact"),
        "periodic": make_simulator(g, cm, engine="periodic"),
    }
    cell: dict = {"graph": g.name, "nodes": len(g), "fleet": "8+4", "frames": frames}

    def run_once(s):
        # the compiled engines content-memoize run() on the shared
        # context; drop it so every repeat measures a full evaluation
        ctx = getattr(s, "_ctx", None)
        if ctx is not None:
            ctx.memo.clear()
        s.run(a, frames=frames)

    for name, sim in sims.items():
        cell[f"{name}_s"] = _best(lambda s=sim: run_once(s))
    cell["speedup_exact"] = cell["reference_s"] / cell["exact_s"]
    cell["speedup_periodic"] = cell["reference_s"] / cell["periodic_s"]
    cell["early_exit"] = sims["periodic"].last_early_exit

    # raw event-loop throughput (saturated pass only, no run() overhead)
    in_flight = 14
    ev = {}
    for name in ("reference", "exact"):
        sim = sims[name]
        dt = _best(lambda s=sim: s._simulate(a, frames=frames, in_flight=in_flight))
        ev[name] = sim.last_events / dt
    cell["events_per_sec"] = ev
    return cell


def mt_cell(frames: int) -> dict:
    """Multi-tenant trajectory point: 2x ResNet-8 + ResNet-18 co-served
    (mixed weights — the rn8 pair is weight-equal, rn18 rationalizes to
    a small fraction against them) under lblp-mt on an 8+4 fleet.

    The heterogeneous fair-queueing transient (the virtual-time gap
    drifting to its equilibrium) spans ~300 completions on this mix, so
    the steady-state exit only pays off at serving-scale frame budgets;
    the cell therefore runs at >= 512 frames per tenant."""
    frames = max(frames, 512)
    mt = MultiTenantGraph.union([resnet8_graph(), resnet8_graph(), resnet18_graph()])
    cm = CostModel()
    a = get_scheduler("lblp-mt", cm).schedule(mt, make_pus(8, 4))
    cell: dict = {
        "graph": "2x resnet8 + resnet18",
        "tenants": len(mt.tenants),
        "nodes": len(mt),
        "fleet": "8+4",
        "frames": frames,
    }
    in_flight = len(a.pus) + 2
    for name in ("reference", "exact", "periodic"):
        sim = make_simulator(mt, cm, engine=name)
        cell[f"{name}_s"] = _best(lambda s=sim: s._run_streams(a, frames, in_flight=in_flight))
        if name == "periodic":
            cell["early_exit"] = sim.last_early_exit
    cell["speedup_exact"] = cell["reference_s"] / cell["exact_s"]
    cell["speedup_periodic"] = cell["reference_s"] / cell["periodic_s"]
    return cell


def run_suites(frames: int, repeats: int = 2) -> dict:
    """Time the simulator-driven ``benchmarks_torch.run`` suites under the
    reference engine and the current default, mimicking ``run.py``'s
    frame forwarding: ``repeats`` rounds, each running every suite once
    under each engine in turn."""
    res: dict = {
        "frames": frames,
        "suites": {},
        "note": (
            "simulator-driven suites of benchmarks_torch.run; kernels (the card) and "
            "partition (no simulator) excluded — their wall-clock is "
            "independent of the event loop"
        ),
    }
    from .run import SUITES

    runners = {}
    for name in SIM_SUITES:
        fn = importlib.import_module(f".{SUITES[name]}", package=__package__).main
        kw = {}
        if "frames" in inspect.signature(fn).parameters:
            kw["frames"] = frames

        def run_once(fn=fn, kw=kw):
            with redirect_stdout(io.StringIO()):
                fn(**kw)
        runners[name] = run_once

    # the two engines run in turn, and every suite once a round: the
    # ref/new *ratio* is the trajectory figure, and the median of a
    # suite's paired ratios, spread over the rounds, keeps the host's
    # speed drift and its slow spells out of it
    default_mode = common.SIM_MODE
    pairs: dict = {name: [] for name in SIM_SUITES}
    try:
        for _ in range(repeats):
            for name, run_once in runners.items():
                pair = []
                for engine in ("reference", default_mode):
                    common.SIM_MODE = engine
                    pair.append(_timed(run_once))
                pairs[name].append(pair)
    finally:
        common.SIM_MODE = default_mode
    for name, got in pairs.items():
        res["suites"][name] = {
            "ref_s": min(p[0] for p in got), "new_s": min(p[1] for p in got),
            "speedup": statistics.median(p[0] / p[1] for p in got)}
    res["total_ref_s"] = sum(c["ref_s"] for c in res["suites"].values())
    res["total_new_s"] = sum(c["new_s"] for c in res["suites"].values())
    res["speedup"] = res["total_ref_s"] / res["total_new_s"]
    # the paper-figure sweeps are the deep-streaming workloads the early
    # exit targets; the full mix also carries multi-tenant runs (no
    # multi-stream exit yet) and scheduler-heavy suites, diluting it
    paper = ("fig2", "fig3", "fig4", "table1")
    res["paper_sweeps_ref_s"] = sum(res["suites"][n]["ref_s"] for n in paper)
    res["paper_sweeps_new_s"] = sum(res["suites"][n]["new_s"] for n in paper)
    res["paper_sweeps_speedup"] = res["paper_sweeps_ref_s"] / res["paper_sweeps_new_s"]
    res["engine"] = default_mode
    return res


def check_against(baseline_path: str, res: dict) -> int:
    """Perf gate: compare the just-measured per-suite speedups against a
    committed ``BENCH_sim_torch.json``.  Returns the number of regressions
    beyond ``CHECK_SLACK`` (0 = gate passes).  Ratios are compared, not
    wall-clock, so the gate is machine-speed independent."""
    with open(baseline_path) as f:
        base = json.load(f)
    base_suites = base.get("run_frames64", {}).get("suites", {})
    new_suites = res["run_frames64"]["suites"]
    bad = 0
    print(f"== perf gate vs {baseline_path} (slack {CHECK_SLACK:.0%}) ==")
    for name, cell in sorted(new_suites.items()):
        ref = base_suites.get(name)
        if not ref or "speedup" not in ref:
            print(f"  {name:<14s} (no baseline entry, skipped)")
            continue
        # sub-quarter-second suites measure mostly scheduler + setup:
        # their ref/new ratio is noise-dominated, so they get double
        # slack (still catches any real 2x-class regression)
        slack = CHECK_SLACK if ref.get("ref_s", 1.0) >= 0.25 else 2 * CHECK_SLACK
        floor = ref["speedup"] * (1 - slack)
        ok = cell["speedup"] >= floor
        bad += not ok
        print(
            f"  {name:<14s} baseline {ref['speedup']:5.2f}x -> "
            f"measured {cell['speedup']:5.2f}x (floor {floor:5.2f}x) "
            f"{'ok' if ok else 'REGRESSED'}"
        )
    if bad:
        print(f"perf gate FAILED: {bad} suite(s) regressed > {CHECK_SLACK:.0%}")
    else:
        print("perf gate passed")
    return bad


def main(frames: int = 256, check: str | None = None) -> dict:
    out = {
        "generated": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "yolo_cell": yolo_cell(frames),
        "mt_cell": mt_cell(frames),
        "run_frames64": run_suites(
            min(frames, 64),
            repeats=SUITE_REPEATS if check else BASELINE_ROUNDS),
    }
    yc = out["yolo_cell"]
    mc = out["mt_cell"]
    rf = out["run_frames64"]
    print(f"== sim_speed (engine: {common.SIM_MODE}) ==")
    print(
        f"yolo {yc['frames']}f cell: reference {yc['reference_s']:.3f}s | "
        f"exact {yc['exact_s']:.3f}s ({yc['speedup_exact']:.2f}x) | "
        f"periodic {yc['periodic_s']:.3f}s ({yc['speedup_periodic']:.2f}x, "
        f"early exit {yc['early_exit']})"
    )
    print(
        f"mt   {mc['frames']}f cell ({mc['graph']}): "
        f"reference {mc['reference_s']:.3f}s | "
        f"exact {mc['exact_s']:.3f}s ({mc['speedup_exact']:.2f}x) | "
        f"periodic {mc['periodic_s']:.3f}s ({mc['speedup_periodic']:.2f}x, "
        f"early exit {mc['early_exit']})"
    )
    eps = yc["events_per_sec"]
    print(
        f"event loop: {eps['reference'] / 1e3:.0f}k ev/s reference -> "
        f"{eps['exact'] / 1e3:.0f}k ev/s compiled"
    )
    print(
        f"benchmarks_torch.run --frames {rf['frames']} (sim suites): "
        f"{rf['total_ref_s']:.1f}s reference -> {rf['total_new_s']:.1f}s "
        f"({rf['speedup']:.2f}x; paper-figure sweeps "
        f"{rf['paper_sweeps_speedup']:.2f}x)"
    )
    for name, cell in sorted(rf["suites"].items()):
        vs_pr3 = ""
        if name in PR3_REF_S:
            cell["pr3_ref_s"] = PR3_REF_S[name]
            cell["speedup_vs_pr3_ref"] = PR3_REF_S[name] / cell["new_s"]
            vs_pr3 = f"  [vs PR3 ref {cell['speedup_vs_pr3_ref']:5.2f}x]"
        print(
            f"  {name:<14s} {cell['ref_s']:7.2f}s -> {cell['new_s']:6.2f}s "
            f"({cell['speedup']:5.2f}x){vs_pr3}"
        )
    csv_line("sim_speed.yolo.speedup_periodic", 0.0, f"{yc['speedup_periodic']:.2f}x")
    csv_line("sim_speed.mt.speedup_periodic", 0.0, f"{mc['speedup_periodic']:.2f}x")
    csv_line("sim_speed.run_frames64.speedup", 0.0, f"{rf['speedup']:.2f}x")
    if check is not None:
        bad = check_against(check, out)
        if bad:
            # one full re-measure before failing: a throttled runner can
            # sink any single suite pass by more than the gate's slack
            print("re-measuring once to rule out runner noise ...")
            out["run_frames64"] = run_suites(min(frames, 64),
                                             repeats=SUITE_REPEATS)
            bad = check_against(check, out)
        out["check"] = {"baseline": check, "regressions": bad}
        path = dump("sim_speed", out)
        print(f"artifact: {path}")
        if bad:
            raise SystemExit(1)
        return out
    with open(ROOT_JSON, "w") as f:
        json.dump(out, f, indent=2)
    path = dump("sim_speed", out)
    print(f"artifacts: {os.path.abspath(ROOT_JSON)}, {path}")
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    kw: dict = {}
    if "--frames" in args:
        i = args.index("--frames")
        kw["frames"] = int(args[i + 1])
        del args[i : i + 2]
    if "--check" in args:
        i = args.index("--check")
        kw["check"] = args[i + 1]
        del args[i : i + 2]
    if args:
        print("usage: python -m benchmarks_torch.sim_speed [--frames N] "
              "[--check BASELINE.json]")
        raise SystemExit(2)
    main(**kw)
