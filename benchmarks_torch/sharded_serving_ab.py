"""Phase 17 of ``chip_smoke.py`` timed on several checkouts in turn, one
process a run and nothing else running beside it, so that two versions
of the sharded path are compared within one call on one card.

Each ROOT is a checkout holding ``chip_smoke.py`` and ``src/``.  A run
imports that checkout's ``chip_smoke`` (which puts its own ``src/``
first on the path, so the kernels are built from its sources) and calls
its ``sharded_serving``: granite-moe-3b-a800m at full width and depth,
random weights from seed 0, a prefill of (4, 2,048) tokens and 32
greedy decode steps, unsharded and then on a one-rank NCCL mesh with the
parameters, batch and cache as DTensors; the sharded tokens must equal
the unsharded ones.  Its prefill time and the mean and max of its decode
steps are host-clock seconds around synchronized steps.

After the phase, the run counts the DTensor-level ops of one sharded
prefill and one decode step on the host (``dtensor_ops``), the host work
that the sharded path adds and that the host's drifting speed cannot
blur.  Prints one JSON line a run (the root, the card's name and power
limit as ``nvidia-smi`` gives them, the phase's record, the counts) and
writes the list to ``--out``.  Give the roots in an order that brackets drift, such as
parent, change, change, parent.

Usage:
  python -m benchmarks_torch.sharded_serving_ab ROOT [ROOT ...] \\
      [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = """
import importlib.util, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
spec = importlib.util.spec_from_file_location("ab", sys.argv[2])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device")
rec = chip_smoke.sharded_serving(torch.device("cuda"), torch.cuda.synchronize)
rec.update(ab.dtensor_ops(chip_smoke.MAIN_ARCH, chip_smoke.free_port()))
print("RECORD " + json.dumps(rec))
"""


def dtensor_ops(arch: str, port: int, batch: int = 4, prompt: int = 64
                ) -> dict:
    """DTensor-level ops (each op with a DTensor among its arguments, as
    a dispatch mode above DTensor sees them) of one sharded prefill and
    one decode step of ``arch``'s smoke config at full depth, f32, on a
    one-rank gloo mesh on the host: the host work the sharded path adds
    a step, counted where the clock cannot drift.  Uses whichever
    ``repro_torch`` the process imported."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import model, sharding, transformer
    from repro_torch.tree import tree_map

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, DTensor) for a in tree_leaves((args,
                                                                kwargs))):
                n[0] += 1
            return func(*args, **kwargs)

    full = get_config(arch)
    cfg = dataclasses.replace(full.smoke(), segments=full.segments)
    params = tree_map(lambda t: t.float(), transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    toks = torch.randint(0, cfg.vocab, (batch, prompt),
                         generator=torch.Generator().manual_seed(1))
    prefill = model.make_prefill_step(cfg, prompt + 2)
    decode = model.make_decode_step(cfg)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        dparams = sharding.distribute(params, sharding.param_shardings(
            cfg, mesh, params))
        batch = {"tokens": toks}
        dbatch = sharding.distribute(batch, sharding.batch_shardings(mesh,
                                                                     batch))
        with sharding.activation_mesh(mesh):
            with Count():
                logits, cache = prefill(dparams, dbatch)
            counts = {"dtensor_ops_prefill": n[0]}
            cache = sharding.distribute(cache, sharding.cache_shardings(
                mesh, cache))
            tok = torch.argmax(logits[:, -1:], dim=-1)
            n[0] = 0
            with Count():
                decode(dparams, tok, cache)
            counts["dtensor_ops_decode"] = n[0]
    finally:
        dist.destroy_process_group()
    return counts


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run(root: Path, timeout: float = 900) -> dict:
    """One run of ``root``'s phase 17 in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", CHILD, str(root),
                          str(Path(__file__).resolve())], cwd=root, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: exit {res.returncode}\n"
                           f"{res.stderr[-4000:]}")
    line = [x for x in res.stdout.splitlines() if x.startswith("RECORD ")]
    return json.loads(line[-1][len("RECORD "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m benchmarks_torch.sharded_serving_ab")
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    out = []
    for root in args.roots:
        rec = {"root": str(root), "card": card(), **run(root.resolve())}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0 if all(r["tokens_equal"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
