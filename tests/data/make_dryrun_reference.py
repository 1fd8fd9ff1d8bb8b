"""Writes ``tests/data/dryrun_reference_pod16x16.json``: the reference's
dry run (``repro.launch.dryrun.run_cell``) of every (arch x shape) cell
on the single-pod 16x16 mesh, its ``memory`` and ``cost`` (or the
reason ``shape_supported`` skips the cell).

The reference builds its mesh with ``jax.make_mesh(shape, axes)``, whose
axes default to ``Explicit`` on recent jax releases, where
``with_sharding_constraint`` refuses them.  Each cell therefore runs in
its own process (the reference sets ``XLA_FLAGS`` for 512 placeholder
devices when it is imported) with ``make_production_mesh`` replaced by
the same mesh on ``Auto`` axes; ``src/repro/`` is not edited.

Usage (from the repo root; about 4 minutes on 8 cores):
  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/make_dryrun_reference.py [-j 4]

``--compare DIR`` writes nothing and runs nothing: it prints, for every
pod16x16 cell of the port's dry run in ``DIR`` (``artifacts/dryrun_torch``
by default, from ``python -m repro_torch.launch.dryrun --all``), the
port / reference ratios of peak (raw, and against the reference's less
its f32 copies), FLOPs and matrix-product FLOPs, the collective bytes
by kind of the port, of the reference and of the reference with its
tuple collectives, and how many cells fall within 1.2x and 2x.

``tests/test_torch_dryrun_parity.py`` checks two cells of the file
against a live run, holds the port's dry run against two cells, and
``chip_smoke.py`` prints the port's ratios to it.  Tier-1 never runs
this script.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "dryrun_reference_pod16x16.json"
ARCHS = ("gemma3-1b", "stablelm-1.6b", "starcoder2-3b", "gemma2-27b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
         "recurrentgemma-9b", "whisper-small", "paligemma-3b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

#: run in a child process: one reference cell on an Auto-axes mesh.  Every
#: program the cell compiles (the cell itself, then the E/B variants in
#: ``corrected_costs``'s order) is kept, for two figures the reference
#: does not report: ``cost["dot_flops_per_device"]``, the E/B-corrected
#: FLOPs of its ``dot`` ops alone (2 x result elements x contracted
#: elements), and ``memory["f32_copy_bytes"]``, the bytes of the f32
#: copies XLA:CPU makes of bf16 arguments (it has no bf16 dot, so its
#: float normalization upcasts every bf16 weight and cache that feeds
#: one): 4 bytes an element of each bf16 entry parameter whose dims some
#: f32 ``convert`` in the cell's program has.  And
#: ``cost["collective_bytes_with_tuples"]``: collective bytes by kind with
#: the E/B correction, counting the collectives whose result is a tuple
#: (XLA combines gradient and activation all-reduces into one op), which
#: the reference's ``parse_collectives`` regex does not match.
CELL = r"""
import json, re, sys
import repro.launch.dryrun as dryrun
import jax
from jax.sharding import AxisType

def make_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(shape))

texts = []
compile_cell = dryrun.compile_cell

def keep_text(*args, **kwargs):
    compiled = compile_cell(*args, **kwargs)
    texts.append(compiled.as_text())
    return compiled

DEF = re.compile(r"(%[\w.\-]+) = (\w+)\[([\d,]*)\]")
DOT = re.compile(r"(%[\w.\-]+) = \w+\[([\d,]*)\]\S* dot\((%[\w.\-]+), "
                 r"(%[\w.\-]+)\).*lhs_contracting_dims=\{([\d,]*)\}")

def dims(text):
    return [int(x) for x in text.split(",") if x]

def prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n

def dot_flops(text):
    shapes = {m.group(1): dims(m.group(3)) for m in DEF.finditer(text)}
    total = 0
    for m in DOT.finditer(text):
        lhs = shapes[m.group(3)]
        total += 2 * prod(dims(m.group(2))) * prod(
            lhs[i] for i in dims(m.group(5)))
    return float(total)

SIZE = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
        "u32": 4, "s8": 1, "u8": 1, "pred": 1}
COLL = re.compile(r"= (\(.*?\)|\w+\[[\d,]*\]\S*) (all-reduce|all-gather|"
                  r"reduce-scatter|all-to-all|collective-permute)(?:-start)?\(")
ARRAY = re.compile(r"(\w+)\[([\d,]*)\]")

def collectives(text):
    out = {}
    for m in COLL.finditer(text):
        n = sum(SIZE.get(a.group(1), 4) * prod(dims(a.group(2)))
                for a in ARRAY.finditer(m.group(1)))
        out[m.group(2)] = out.get(m.group(2), 0.0) + n
    return out

def f32_copy_bytes(text):
    entry = text[text.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    converted = {tuple(dims(m.group(3))) for m in DEF.finditer(text)
                 if m.group(2) == "f32" and " convert(" in
                 text[m.end():text.find("\n", m.end())]}
    n = 0
    for line in entry.splitlines():
        m = DEF.search(line)
        if m and m.group(2) == "bf16" and " parameter(" in line \
                and tuple(dims(m.group(3))) in converted:
            n += 4 * prod(dims(m.group(3)))
    return n

dryrun.make_production_mesh = make_production_mesh
dryrun.compile_cell = keep_text
res = dryrun.run_cell(sys.argv[1], sys.argv[2], False)
if res["status"] == "ok":
    res["memory"]["f32_copy_bytes"] = f32_copy_bytes(texts[0])
    cost = res["cost"]
    e = dot_flops(texts[1])
    bodies = [max(dot_flops(t) - e, 0.0) for t in texts[2:]]
    counts = [s["n"] for s in cost["segments"]]
    cost["dot_flops_per_device"] = (e + sum(
        n * b for n, b in zip(counts, bodies))) * cost["n_microbatches"]
    e_coll = collectives(texts[1])
    total = dict(e_coll)
    for n, t in zip(counts, texts[2:]):
        c = collectives(t)
        for k in set(c) | set(total):
            total[k] = total.get(k, 0.0) + n * max(
                c.get(k, 0.0) - e_coll.get(k, 0.0), 0.0)
    cost["collective_bytes_with_tuples"] = {
        k: v * cost["n_microbatches"] for k, v in total.items()}
keep = ("arch", "shape", "mesh", "status", "reason", "devices", "memory",
        "cost")
print(json.dumps({k: res[k] for k in keep if k in res}))
"""


def reference_cell(arch: str, shape: str, timeout: float = 900) -> dict:
    """The reference's dry run of one pod16x16 cell, in a subprocess."""
    root = HERE.parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", CELL, arch, shape], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=root)
    if res.returncode != 0:
        raise RuntimeError(f"{arch} x {shape}: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def compare(art_dir: Path) -> None:
    from repro_torch.launch.dryrun import against_reference
    cells = json.loads(OUT.read_text())["cells"]
    rows = []
    for name, ref in sorted(cells.items()):
        if ref["status"] != "ok":
            continue
        path = art_dir / f"{name}__pod16x16.json"
        if not path.exists():
            print(f"{name}: no port artifact")
            continue
        port = json.loads(path.read_text())
        if port["status"] != "ok":
            print(f"{name}: port {port['status']}")
            continue
        r = against_reference(port, ref)
        rows.append(r)
        coll = ", ".join(f"{k} {g / 2**20:.1f}/{w / 2**20:.1f}/"
                         f"{t / 2**20:.1f}"
                         for k, (g, w, t) in r["collectives"].items())
        print(f"{name}: peak {r['peak']:.2f}x (held {r['peak_held']:.2f}x), "
              f"FLOPs {r['flops']:.2f}x (matmul {r['matmul_flops']:.2f}x), "
              f"args {'==' if r['argument_equal'] else '!='}; collectives "
              f"MiB port/ref/ref with tuples: {coll}")

    def within(key, lim):
        return sum(1 for r in rows if 1 / lim <= r[key] <= lim)

    print(f"{len(rows)} cells: arguments equal in "
          f"{sum(r['argument_equal'] for r in rows)}")
    for key in ("flops", "matmul_flops", "peak", "peak_held"):
        print(f"  {key}: within 1.2x {within(key, 1.2)}, within 2x "
              f"{within(key, 2)}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("-j", type=int, default=4, help="cells at a time")
    ap.add_argument("--compare", nargs="?", const="artifacts/dryrun_torch",
                    default=None, metavar="DIR")
    args = ap.parse_args()
    if args.compare is not None:
        compare(HERE.parents[1] / args.compare)
        return
    cells = [(a, s) for a in ARCHS for s in SHAPES]
    with ThreadPoolExecutor(args.j) as pool:
        results = list(pool.map(lambda c: reference_cell(*c), cells))
    out = {"generator": "tests/data/make_dryrun_reference.py",
           "mesh": "pod16x16",
           "cells": {f"{r['arch']}__{r['shape']}": r for r in results}}
    OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"wrote {OUT}: {n_ok} ok, {len(results) - n_ok} skipped")


if __name__ == "__main__":
    main()
