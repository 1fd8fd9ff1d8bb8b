"""Benchmark harness entry point of the port: one experiment per paper
table/figure, and the kernel micro-benchmark.
``python -m benchmarks_torch.run [--frames N] [names...]``

Counterpart of ``benchmarks.run``, with the suites ported so far (the
beyond-paper suites and ``sim_speed`` are not ported yet).  ``--frames
N`` forwards a small frame count to every suite whose ``main`` accepts
one.  The host suites run anywhere; ``kernels`` runs on the card.

Prints ``CSV,name,us_per_call,derived`` lines for machine consumption and
writes JSON artifacts under artifacts/bench_torch/.
"""

from __future__ import annotations

import importlib
import inspect
import sys
import time

#: suite name -> module under benchmarks_torch/ (imported lazily: the host
#: suites never import torch's CUDA side)
SUITES = {
    "fig2": "fig2_resnet8",
    "fig3": "fig3_resnet18",
    "table1": "table1_utilization",
    "fig4": "fig4_imc_dpu",
    "yolo": "yolo_latency",
    "kernels": "kernel_bench",
}


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    frames = None
    if "--frames" in args:
        i = args.index("--frames")
        try:
            frames = int(args[i + 1])
        except (IndexError, ValueError):
            print("usage: python -m benchmarks_torch.run [--frames N] "
                  "[names...]")
            raise SystemExit(2)
        del args[i : i + 2]
    want = args or list(SUITES)
    t0 = time.time()
    for name in want:
        if name not in SUITES:
            print(f"unknown suite '{name}'; have {sorted(SUITES)}")
            continue
        module = importlib.import_module(f".{SUITES[name]}", package=__package__)
        fn = module.main
        kw = {}
        if frames is not None and "frames" in inspect.signature(fn).parameters:
            kw["frames"] = frames
        print(f"\n######## {name} ########")
        t1 = time.time()
        fn(**kw)
        print(f"[{name} done in {time.time()-t1:.1f}s]")
    print(f"\nall benchmarks done in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
