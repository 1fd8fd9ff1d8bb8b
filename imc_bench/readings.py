"""The readings a correctness limit is set from, on the card, in one process.

    python3 -m imc_bench.readings --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 2] [--out readings.json]

For each ``--seeds`` seed, a run of the cell as ``imc_bench.run`` makes it
(a window of ``--seconds``): the numbers the port's outputs read against
the reference.  For each ``--control-seeds`` seed, the control: the
reference computed in the next precision below the configuration's
(``reference.prepare(..., control=True)``), put in the port's place on
every distinct input batch of the cell and compared the same way.  A
limit lies above the first readings and below the second.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from imc_bench import run as bench_run
from imc_bench import spec


def control_reading(cell, m) -> dict:
    """The control's worst numbers over the cell's distinct batches."""
    ref, cfg = cell.reference, cell.config
    state = ref.prepare(cfg, m.params, m.calib, control=True)
    kept = [(b, ref.forward(cfg, state, m.inputs[b]))
            for b in range(m.inputs.shape[0])]
    del state
    return bench_run.compared(cell, m, kept)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = bench_run.ROOT
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("imc_bench.readings: no CUDA device", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(),
           "program": [], "control": []}
    for seed in args.seeds:
        t = time.perf_counter()
        r = bench_run.run_cell(root, args.workload, seed, args.seconds, False)
        rec = {"seed": seed, "correct": r["correct"],
               "checks": {k: v["value"] for k, v in r["checks"].items()},
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "seconds": time.perf_counter() - t}
        out["program"].append(rec)
        print(json.dumps(rec), flush=True)
    cell = spec.cell(root, args.workload)
    for seed in args.control_seeds:
        m = bench_run.materials(cell, seed, "cuda")
        rec = {"seed": seed, "checks": control_reading(cell, m)}
        del m
        torch.cuda.empty_cache()
        out["control"].append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
