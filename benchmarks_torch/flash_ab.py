"""The flash kernel of two or more trees, side by side on one card.

Builds ``src/repro_torch/csrc/flash_attention.cu`` of each tree given (a
checkout of another commit, unpacked by ``git archive`` into a directory
``.gitignore`` lists, and this one) with the port's ``nvcc`` flags into a
temporary directory, one ``nvcc`` per tree at once, loads each library's
C entry ``flash_attention_launch`` with ctypes (a tree whose entry takes
other arguments cannot be compared) and times bf16 flash at the served
prefill shapes with CUDA events, back to back: for each case the trees in
the order given, then again in reverse, ``--rounds`` times.  Each tree's
output is held against the plain version on the same inputs
(``ref.check_flash``: 2e-4 against the f32 upcast, 2e-2 against bf16).
Prints µs a launch per tree and case, the per-prefill sums of the paths
that launch them, and writes JSON::

    python -m benchmarks_torch.flash_ab artifacts/parent . \\
        --out artifacts/bench_torch/flash_ab.json

Inputs are (B, S, heads, hd) projections viewed as (B, heads, S, hd), as
the models pass them.  Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import NO_WINDOW

from .kernel_bench import card_line

#: name, (B, H, KV, S, hd), causal, window, launches a prefill, path:
#: phase 14's granite prefill, phase 15's 1-layer qwen3-moe and whisper
#: (12 encoder layers at 1,500 frames, 12 decoder layers at 64 tokens),
#: and the hd 256-288 layers of recurrentgemma and gemma3-1b
CASES = (
    ("granite", (4, 24, 8, 2048, 64), True, None, 32, "granite_prefill"),
    ("qwen3-moe", (4, 64, 4, 2048, 64), True, None, 1, "qwen3_prefill"),
    ("whisper-enc", (4, 12, 12, 1500, 64), False, None, 12,
     "whisper_prefill"),
    ("whisper-dec", (4, 12, 12, 64, 64), True, None, 12, "whisper_prefill"),
    ("recurrentgemma", (4, 16, 1, 3072, 256), True, 2048, 12,
     "recurrentgemma_prefill"),
    ("gemma3-local", (4, 4, 1, 2048, 288), True, 512, 22, "gemma3_prefill"),
    ("gemma3-global", (4, 4, 1, 2048, 288), True, None, 4, "gemma3_prefill"),
)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])


def build(trees: List[Path], out_dir: Path) -> List[ctypes._CFuncPtr]:
    """Each tree's flash library, built at once; its launch entry."""
    procs = []
    for i, tree in enumerate(trees):
        src = tree / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
        lib = out_dir / f"flash_{i}.so"
        procs.append((lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        fns.append(fn)
    return fns


def launcher(fn, q, k, v, out, causal, window):
    """A call of one tree's launch entry on these tensors."""
    B, H, S, hd = q.shape
    win = NO_WINDOW if window is None else window
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                B, H, k.shape[1], S, hd, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], 1.0 / math.sqrt(hd), int(causal), win, 0.0,
                stream)
        _build.check(rc, "flash_attention")
    return call


def events_us(call, iters: int) -> float:
    """Mean device time of ``iters`` back-to-back calls, after one."""
    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def run(trees: List[Path], rounds: int, iters: int) -> Dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(trees, Path(tmp))
        cases = {}
        for name, (B, H, KV, S, hd), causal, window, n, path in CASES:
            q, k, v = (torch.randn((B, S, h, hd), generator=gen, device=dev)
                       .to(torch.bfloat16).transpose(1, 2) for h in (H, KV, KV))
            outs = [torch.empty((B, H, S, hd), device=dev) for _ in fns]
            calls = [launcher(fn, q, k, v, o, causal, window)
                     for fn, o in zip(fns, outs)]
            errs = []
            for call, o in zip(calls, outs):
                call()
                torch.cuda.synchronize()
                errs.append(ref.check_flash(o, q, k, v, causal, window, None,
                                            name)[0])
            times = [[] for _ in fns]
            for r in range(rounds):
                order = range(len(fns)) if r % 2 == 0 else \
                    reversed(range(len(fns)))
                for i in order:
                    times[i].append(events_us(calls[i], iters))
            cases[name] = {"shape": [B, H, KV, S, hd], "causal": causal,
                           "window": window, "launches": n, "path": path,
                           "us": [sorted(t)[len(t) // 2] for t in times],
                           "us_all": times, "max_abs_err": errs}
            print(f"{name:<15s} {str((B, H, KV, S, hd)):<24s}"
                  + "".join(f"{u:12.2f}" for u in cases[name]["us"])
                  + f"   x{n} ({path}); max |d| "
                  + ", ".join(f"{e:.2e}" for e in errs), flush=True)
    sums: Dict[str, List[float]] = {}
    for rec in cases.values():
        acc = sums.setdefault(rec["path"], [0.0] * len(trees))
        for i, u in enumerate(rec["us"]):
            acc[i] += rec["launches"] * u
    for path, acc in sums.items():
        print(f"{path:<24s} a prefill:" + "".join(f"{u:12.2f}" for u in acc)
              + " µs", flush=True)
    return {"trees": [str(t) for t in trees], "rounds": rounds,
            "iters": iters, "card": card_line(), "cases": cases,
            "path_sums_us": sums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab needs the card")
    print(card_line(), flush=True)
    print("; ".join(f"tree {i}: {t}" for i, t in enumerate(args.trees)),
          flush=True)
    print(f"{'case':<15s} {'(B, H, KV, S, hd)':<24s}"
          + "".join(f"{f'tree {i}':>12s}" for i in range(len(args.trees)))
          + "   µs a launch (median of rounds)", flush=True)
    res = run(args.trees, args.rounds, args.iters)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
