"""One run of one cell of the port's benchmark.

    python3 -m imc_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (``setup_s``, from this module's
first line): the port is imported from ``src/``; the weights are drawn on
the card from ``--seed`` in one call, the calibration batch from seed + 1
and the cell's distinct input batches from seed + 2; the configuration's
module builds the port's served request (its kernels built on the
checkout's first run, weights programmed, the request's CUDA graph
captured); warm-up requests run through the cell's own loop.  Then the
window: the closed loop of ``loop.drive`` for ``--seconds``.  With
``--trace 1`` a slice of the traffic's ``trace_requests`` requests
follows, through the same loop under ``torch.profiler``, and the line
carries the per-layer metrics instead of the end-to-end ones.

Once the window has closed and the device's peak memory is read, the
port's request is freed and a sample of the requests' outputs (drawn from
the seed) is compared with the configuration's plain reference, run on
the same weights, calibration batch and frames.  Each number compared is
printed beside its limit, last on standard error and under ``checks`` at
the end of the result's line, the last line on standard output.

Exits non-zero with no result where there is no card (or fewer than the
cell asks for), where the port cannot be imported, where a metric that
``BENCHMARK.json`` lists for the cell reads nothing, and where ``jax``,
``jaxlib``, ``flax``, ``repro``, ``benchmarks`` or ``benchmarks_torch``
is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "benchmarks_torch")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of ``modules`` (``sys.modules``) that are in
    ``FORBIDDEN``, each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Materials(NamedTuple):
    params: Dict
    calib: Optional[object]   # NHWC calibration batch, or None
    inputs: object            # (distinct, frames, H, W, 3)
    order: list               # the distinct batches' order in the cycle


def materials(cell, seed: int, device: str) -> Materials:
    """Weights, calibration batch, input batches and their order, all from
    ``seed``."""
    import torch
    from imc_bench import weights
    cfg, traffic = cell.config, cell.traffic
    hw = tuple(cfg["image_hw"])

    def gen(offset):
        return torch.Generator(device=device).manual_seed(seed + offset)
    params = weights.make(cell.reference.param_shapes(cfg), gen(0))
    n_cal = cfg.get("calibration_frames", 0)
    calib = weights.frames(gen(1), 1, n_cal, hw)[0] if n_cal else None
    inputs = weights.frames(gen(2), traffic["distinct_batches"],
                            traffic["frames_per_request"], hw)
    order = list(range(traffic["distinct_batches"]))
    random.Random(seed).shuffle(order)
    return Materials(params, calib, inputs, order)


def compared(cell, m: Materials, kept) -> Dict[str, float]:
    """The worst of each number ``reference.compare`` gives over the kept
    (batch, output) pairs, against the reference on the same batch."""
    import torch
    ref, cfg = cell.reference, cell.config
    state = ref.prepare(cfg, m.params, m.calib)
    want, worst = {}, {}
    for b, out in kept:
        if b not in want:
            want[b] = ref.forward(cfg, state, m.inputs[b])
        for k, v in ref.compare(out, want[b]).items():
            worst[k] = max(worst.get(k, v), v)
    del state, want
    if m.inputs.device.type == "cuda":
        torch.cuda.empty_cache()
    return worst


class Run(NamedTuple):
    """What a metric's ``read(run)`` sees."""
    cell: object              # spec.Cell
    setup_s: float
    window: object            # loop.Window
    traced: Optional[object]  # trace.Traced, with --trace 1
    request: object           # the port's served request


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             wrap: Callable = None) -> Dict:
    """One run of ``workload`` on ``device``; returns the result's fields.
    ``wrap(request)``, where given, stands in for the served request (a
    test plants a fault with it)."""
    import torch
    from imc_bench import loop, spec
    from imc_bench import trace as tr
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(root, workload)
    cfg, traffic = cell.config, cell.traffic
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    m = materials(cell, seed, device)
    request = cell.port.request(cfg, m.params, m.calib)
    if wrap is not None:
        request = wrap(request)
    in_flight = traffic["in_flight"]
    loop.drive(request, m.params, m.inputs, m.order, in_flight, None,
               count=traffic["warmup_requests"])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    sample = loop.Sample(traffic["checked_requests"], random.Random(seed + 3))
    window = loop.drive(request, m.params, m.inputs, m.order, in_flight,
                        sample, seconds=seconds)
    traced = None
    if trace:
        first = len(window.complete)
        t_trace = time.perf_counter()
        traced = tr.record(lambda: len(loop.drive(
            request, m.params, m.inputs, m.order, in_flight, sample,
            count=traffic["trace_requests"], first=first).complete),
            traffic["frames_per_request"])
        print(f"traced slice: {traced.requests} requests, "
              f"{len(traced.ops)} device operations, "
              f"{traced.seconds:.6f} s traced, "
              f"{time.perf_counter() - t_trace:.1f} s with the trace's reading",
              file=sys.stderr)
    attempted = sample.seen
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    run = Run(cell, setup_s, window, traced, request)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for entry in entries:
        value = spec.reader(root, entry["name"])(run)
        if value is None:
            raise RuntimeError(f"metric {entry['name']} read nothing in {workload}, "
                               "which BENCHMARK.json says it reports")
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    del run, request
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    worst = compared(cell, m, sample.kept)
    limits = cfg["limits"]
    correct = bool(sample.kept) and set(worst) == set(limits) and all(
        worst[k] <= limits[k] for k in limits)
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name() if cuda else "cpu",
                  "count": cell.chips if cuda else 0,
                  "memory_peak_bytes": memory_peak}
    if traced is not None:
        device_rec["busy_s"] = tr.busy_seconds(traced)
        device_rec["window_s"] = traced.seconds
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_rec}
    if traced is not None:
        result["breakdown"] = tr.breakdown(traced)
    result["checks"] = {k: {"value": _json_number(worst.get(k)), "limit": limits[k]}
                        for k in limits}
    return result


def _json_number(v):
    """``v`` as JSON holds it: an infinite or NaN reading (a wrong shape,
    a non-finite output) as its text."""
    return v if v is None or math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from imc_bench import spec
    chips = spec.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"imc_bench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    found = forbidden_loaded()
    if found:
        print(f"imc_bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
