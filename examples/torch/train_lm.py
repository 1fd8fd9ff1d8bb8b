"""End-to-end driver: train a ~100M-parameter decoder LM on the port for
a few hundred steps on the synthetic pipeline, with checkpointing and
resume.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import os

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import Segment, ShapeSpec
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainLoopConfig, train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_100m_config():
    """~100M params: stablelm-family geometry scaled down."""
    base = get_config("stablelm-1.6b")
    return dataclasses.replace(
        base,
        name="stablelm-100m",
        d_model=640,
        n_heads=10,
        n_kv_heads=10,
        head_dim=64,
        d_ff=1792,
        vocab=32768,
        segments=(Segment("attn", 12),),
        microbatch=8,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "artifacts", "train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = make_100m_config()
    from repro_torch.models.lm.transformer import param_count
    dev = torch.device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"model: {cfg.name}, {param_count(cfg)/1e6:.1f}M params, "
          f"device {where}")

    shape = ShapeSpec("example", args.seq, args.batch, "train")
    loop = TrainLoopConfig(
        total_steps=args.steps,
        ckpt_every=50,
        ckpt_dir=args.ckpt_dir,
        log_every=20,
        opt=adamw.AdamWConfig(lr=3e-4, warmup_steps=30,
                              total_steps=args.steps),
    )
    report = train(cfg, shape, loop, device=dev)
    first = sum(report.losses[:10]) / max(len(report.losses[:10]), 1)
    last = sum(report.losses[-10:]) / max(len(report.losses[-10:]), 1)
    print(f"\nsteps={report.steps_run} resumed_from={report.resumed_from}")
    print(f"loss: first10={first:.4f} -> last10={last:.4f} "
          f"({report.wall_seconds:.1f}s)")
    assert last < first, "training did not reduce loss"
    print("OK: loss decreased on the synthetic stream")


if __name__ == "__main__":
    main()
