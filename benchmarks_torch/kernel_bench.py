"""Kernel micro-benchmarks on the card, at the reference's shapes.

Counterpart of ``benchmarks.kernel_bench``, which times its jnp oracles
on the host and prints TPU roofline estimates.  The same cases here:
``imc_mvm`` at (M, K, N) = (256, 512, 512), (1024, 1024, 1024) and (128,
4096, 4096) with sx 0.1 and sw 0.01, and flash attention at (B, H, S,
hd) = (2, 8, 1024, 128) and (1, 8, 4096, 128) in f32, causal.

On the card (the default), each case launches the hand-written CUDA
kernel through ``repro_torch.kernels.ops`` and holds its output against
the plain version in ``kernels.ref`` (``torch.equal`` for ``imc_mvm``,
max |d| <= 2e-4 for f32 flash), then times, with CUDA events over
launches back to back after a warm-up: the kernel, the plain version,
and the one PyTorch call that computes the same function, as a
yardstick the port never calls (``torch._int_mm``, the int32 product
without the requant; ``scaled_dot_product_attention`` in f32, named by
the backend it ran).  The bound is the larger of the bytes the case must
move (inputs once, output once) over ``launch.roofline.HBM_BW`` and its
operations over the peak for their type: ``PEAK_INT8_OPS`` for the INT8
product, ``PEAK_F32_FLOPS`` for f32 flash (the CUDA cores; its causal
mask leaves S (S + 1) / 2 key-query pairs a head).  ``launches`` counts
the kernel's launches in the case.

With ``--device cpu`` only the plain versions run, timed on the host
clock, and no card field is written.  A missing card is an error unless
the caller asks for the CPU.

Writes ``artifacts/bench_torch/kernel_bench.json`` under the reference's
keys (``imc_mvm.MxKxN``, ``flash.BxHxSxhd``).

Usage:
  python -m benchmarks_torch.kernel_bench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.imc_mvm import imc_mvm
from repro_torch.launch.roofline import (HBM_BW, PEAK_F32_FLOPS,
                                         PEAK_INT8_OPS)

from .common import csv_line, dump

MVM_SHAPES = ((256, 512, 512), (1024, 1024, 1024), (128, 4096, 4096))
FLASH_SHAPES = ((2, 8, 1024, 128), (1, 8, 4096, 128))
SX, SW = 0.1, 0.01
FLASH_F32_TOL = 2e-4


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_us(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def host_us(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def bound(n_bytes: float, n_ops: float, peak: float, peak_name: str):
    """(bound µs, "bytes" or "operations", the constant that bound it)."""
    t_bytes = n_bytes / HBM_BW * 1e6
    t_ops = n_ops / peak * 1e6
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "HBM_BW"
    return t_ops, "operations", peak_name


def sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` ran for these inputs,
    from the names of the kernels one call launched."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for tag, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient"),
                         ("cutlass", "efficient")):
        if tag in names:
            return backend
    return "math"


def mvm_case(M, K, N, dev, gen, iters):
    qx = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                       dtype=torch.int8)
    sx = torch.full((), SX, device=dev)
    sw = torch.full((N,), SW, device=dev)
    plain = lambda: ref.imc_mvm_ref(qx, qw, sx, sw)  # noqa: E731
    if dev.type == "cpu":
        return {"plain_us": host_us(plain, iters)}
    imc_mvm.launches = 0
    got, want = ops.quantized_matmul(qx, qw, sx, sw), plain()
    if not torch.equal(got, want):
        raise AssertionError(f"imc_mvm {(M, K, N)}: kernel != plain, max |d| "
                             f"{(got - want).abs().max().item()}")
    rec = {"kernel_us": cuda_us(lambda: ops.quantized_matmul(qx, qw, sx, sw),
                                iters),
           "plain_us": cuda_us(plain, max(iters // 10, 2)),
           "library_us": cuda_us(lambda: torch._int_mm(qx, qw), iters),
           "library": "torch._int_mm (int32 product, no requant)",
           "launches": imc_mvm.launches, "max_abs_err": 0.0,
           "check": "torch.equal", "matches_plain": True}
    n_bytes = M * K + K * N + 4 * N + 4 + 4 * M * N
    rec["bound_us"], rec["bound"], rec["bound_constant"] = bound(
        n_bytes, 2.0 * M * K * N, PEAK_INT8_OPS, "PEAK_INT8_OPS")
    return rec


def flash_case(B, H, S, hd, dev, gen, iters):
    q, k, v = (torch.randn((B, H, S, hd), generator=gen, device=dev)
               for _ in range(3))
    plain = lambda: ref.flash_attention_ref(q, k, v)  # noqa: E731
    if dev.type == "cpu":
        return {"plain_us": host_us(plain, iters)}
    flash_attention.launches = 0
    got, want = ops.attention(q, k, v), plain()
    err = (got - want).abs().max().item()
    if not err <= FLASH_F32_TOL:
        raise AssertionError(f"flash {(B, H, S, hd)}: max |kernel - plain| "
                             f"{err:.3e} > {FLASH_F32_TOL}")
    rec = {"kernel_us": cuda_us(lambda: ops.attention(q, k, v), iters),
           "plain_us": cuda_us(plain, max(iters // 10, 2)),
           "library_us": cuda_us(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True), iters),
           "library": f"scaled_dot_product_attention f32 "
                      f"({sdpa_backend(q, k, v)})",
           "launches": flash_attention.launches, "max_abs_err": err,
           "check": f"max |d| <= {FLASH_F32_TOL}", "matches_plain": True}
    pairs = B * H * S * (S + 1) / 2          # unmasked key-query pairs
    rec["bound_us"], rec["bound"], rec["bound_constant"] = bound(
        4.0 * 4 * B * H * S * hd, 4.0 * hd * pairs, PEAK_F32_FLOPS,
        "PEAK_F32_FLOPS")
    return rec


def main(device: str = "cuda", iters: int = 20, mvm_shapes=MVM_SHAPES,
         flash_shapes=FLASH_SHAPES) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel bench: no CUDA device (pass --device cpu "
                           "to time the plain versions on the host)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"kernel bench: device {device!r}, want cuda or cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    card = card_line() if dev.type == "cuda" else None
    print(f"kernel bench on {card or 'the host (plain versions only)'}")
    print("case                    kernel_us   plain_us  library_us  "
          "bound_us  bound")
    cases = [(f"imc_mvm.{M}x{K}x{N}", mvm_case, (M, K, N))
             for M, K, N in mvm_shapes]
    cases += [(f"flash.{B}x{H}x{S}x{hd}", flash_case, (B, H, S, hd))
              for B, H, S, hd in flash_shapes]
    for name, case, shape in cases:
        rec = case(*shape, dev, gen, iters)
        if card is not None:
            rec["card"] = card
            print(f"{name:<22s} {rec['kernel_us']:10.2f} {rec['plain_us']:10.2f}"
                  f" {rec['library_us']:11.2f} {rec['bound_us']:9.2f}  "
                  f"{rec['bound']} ({rec['bound_constant']}); launches "
                  f"{rec['launches']}; {rec['library']}")
            csv_line(name, rec["kernel_us"],
                     f"bound={rec['bound_us']:.2f}us,{rec['bound']}-bound")
        else:
            print(f"{name:<22s} {'-':>10s} {rec['plain_us']:10.2f}")
            csv_line(name, rec["plain_us"], "plain")
        out[name] = rec
    path = dump("kernel_bench", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
