#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a nonzero exit:

1. the card's name and power limit; build every kernel in
   ``src/repro_torch/csrc`` with nvcc (one process per source, in
   parallel) and print the build time and ptxas resource lines;
2. hold each kernel against its plain PyTorch version on the card with
   ``torch.equal``: every ResNet-18-CIFAR conv shape at batch 256, the fc
   shape, and ragged shapes;
3. the main path: ResNet-18-CIFAR at full width (random parameters from
   seed 0), calibrated, serving 8 requests of 256 frames of 32x32x3
   through ``executor.execute(..., mode="int8")``; the launch counters
   must read 20 conv and 1 mvm launches per request, and the logits must
   match the same executor run on CPU copies (the plain path); then
   ResNet-8 once the same way;
4. timings with CUDA events at the path's shapes (kernel, plain version,
   bound), end-to-end frames/s and request latency, and the device's
   busy share over one request from ``torch.profiler``.

Detail goes to ``chiprun_out/chip_smoke.json``.  The line before the last
is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
The script needs a CUDA device and the repository's ``src/``: without
either it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

BATCH = 256
REQUESTS = 8
LOGIT_RTOL = 1e-4      # max |card - cpu| <= LOGIT_RTOL * max |logits|


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_shapes(g, batch):
    """(B, H, W, Cin, Cout, k, stride, padding) of every conv node of ``g``,
    in topological order (the input map is the output map times the
    stride: every ResNet input side is a multiple of it)."""
    out = []
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind.value != "conv":
            continue
        m = n.meta
        k, s = m["k"], m["stride"]
        ho, wo = m["out_hw"]
        out.append((batch, ho * s, wo * s, m["cin_kk"] // (k * k), m["cout"],
                    k, s, m["padding"]))
    return out


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.graph import OpKind
    from repro_torch.kernels import _build, conv2d, imc_mvm as mvm_mod, ref
    from repro_torch.kernels.conv2d import imc_conv2d, pack_weight
    from repro_torch.kernels.imc_mvm import imc_mvm
    from repro_torch.models import quant
    from repro_torch.models.cnn import executor, graphs, layers, resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    detail: dict = {}

    # ---- 1. device and build --------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build()
    detail["build_s"] = time.perf_counter() - t0
    log(f"build: {len(libs)} kernels in {detail['build_s']:.2f} s")
    for name, lib in libs.items():
        log_path = Path(f"{lib}.log")
        lines = log_path.read_text().splitlines() if log_path.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand_int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def rand_scales(n):
        return torch.rand((n,), generator=gen, device=dev) * 0.1 + 1e-3

    # ---- 2. kernels against their plain versions -------------------------
    g18 = graphs.resnet18_graph()
    path_convs = conv_shapes(g18, BATCH)
    distinct = sorted(set(path_convs), key=path_convs.index)
    ragged_convs = [(2, 12, 12, 8, 130, 5, 1, "SAME"),
                    (2, 9, 9, 3, 6, 3, 2, "SAME"),
                    (2, 10, 10, 5, 7, 1, 1, "SAME"),
                    (3, 11, 13, 3, 130, 3, 2, "SAME"),
                    (2, 9, 9, 4, 6, 3, 2, "VALID")]
    err = {"imc_conv2d": 0.0, "imc_mvm": 0.0}
    conv_inputs = {}
    for shape in distinct + ragged_convs:
        B, H, W, cin, cout, k, s, padding = shape
        qx, qw = rand_int8((B, H, W, cin)), rand_int8((k, k, cin, cout))
        sw, bias = rand_scales(cout), torch.randn((cout,), generator=gen,
                                                  device=dev)
        sx = torch.full((), 0.04, device=dev)
        pads = layers.conv_pads(H, W, k, s, padding)
        got = imc_conv2d(qx, qw, sx, sw, bias, stride=s, pads=pads)
        want = ref.conv2d_ref(qx, qw, sx, sw, bias, stride=s, pads=pads)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"imc_conv2d != plain at {shape}: max |d| "
                                 f"{(got - want).abs().max().item()}")
        err["imc_conv2d"] = max(err["imc_conv2d"],
                                (got - want).abs().max().item())
        conv_inputs[shape] = (qx, qw, sx, sw, bias, pads)
    log(f"check imc_conv2d: torch.equal at {len(distinct)} path shapes "
        f"(batch {BATCH}) and {len(ragged_convs)} ragged shapes")

    fc_shape = (BATCH, 256, 10)
    mvm_inputs = {}
    for M, K, N in [fc_shape, (257, 129, 65), (1, 512, 512)]:
        qx, qw = rand_int8((M, K)), rand_int8((K, N))
        sw, bias = rand_scales(N), torch.randn((N,), generator=gen, device=dev)
        sx = torch.full((), 0.02, device=dev)
        got = imc_mvm(qx, qw, sx, sw, bias)
        want = ref.imc_mvm_ref(qx, qw, sx, sw, bias)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"imc_mvm != plain at {(M, K, N)}: max |d| "
                                 f"{(got - want).abs().max().item()}")
        err["imc_mvm"] = max(err["imc_mvm"], (got - want).abs().max().item())
        mvm_inputs[(M, K, N)] = (qx, qw, sx, sw, bias)
    log("check imc_mvm: torch.equal at (256,256,10), (257,129,65), (1,512,512)")

    # ---- 3. main path ------------------------------------------------------
    def reset_counts():
        imc_conv2d.launches = 0
        imc_mvm.launches = 0

    def serve(cfg, g, n_requests, label):
        params = resnet.init(torch.Generator().manual_seed(0), cfg, device=dev)
        data = torch.Generator(device=dev).manual_seed(1)
        x_cal = torch.randn((BATCH, 32, 32, 3), generator=data, device=dev)
        scales = quant.calibrate_resnet(params, x_cal, cfg)
        xs = torch.randn((n_requests, BATCH, 32, 32, 3), generator=data,
                         device=dev)
        executor.execute(g, params, x_cal, mode="int8", act_scales=scales)
        torch.cuda.synchronize()
        reset_counts()
        outs, lat = [], []
        t_all = time.perf_counter()
        for r in range(n_requests):
            t = time.perf_counter()
            outs.append(executor.execute(g, params, xs[r], mode="int8",
                                         act_scales=scales))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        total = time.perf_counter() - t_all
        counts = (imc_conv2d.launches, imc_mvm.launches)
        n_conv, n_mvm = g.num_nodes(OpKind.CONV), g.num_nodes(OpKind.MVM)
        if counts != (n_conv * n_requests, n_mvm * n_requests):
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{(n_conv * n_requests, n_mvm * n_requests)}")
        log(f"{label}: {n_requests} requests x {BATCH} frames; launches "
            f"conv {counts[0]} mvm {counts[1]} ({n_conv} + {n_mvm} per request)")
        for y in outs:
            if y.shape != (BATCH, cfg["num_classes"]) or not torch.isfinite(y).all():
                raise AssertionError(f"{label}: bad logits {tuple(y.shape)}")
        # the plain path: the same executor on CPU copies
        y_cpu = executor.execute(g, to_cpu(params), xs[0].cpu(), mode="int8",
                                 act_scales=scales)
        y_dev = outs[0].cpu()
        dmax = (y_dev - y_cpu).abs().max().item()
        lmax = y_cpu.abs().max().item()
        top1 = bool(torch.equal(y_dev.argmax(-1), y_cpu.argmax(-1)))
        log(f"{label}: card vs cpu plain path: max |d| {dmax:.3e}, "
            f"max |logit| {lmax:.4f}, top-1 identical {top1}")
        if not top1 or dmax > LOGIT_RTOL * lmax:
            raise AssertionError(f"{label}: logits disagree with the plain path")
        return params, scales, xs, lat, total, counts

    reset_counts()
    params, scales, xs, lat, total, counts18 = serve(
        resnet.RESNET18_CIFAR, g18, REQUESTS, "resnet18_cifar")
    fps = REQUESTS * BATCH / total
    detail["e2e"] = {"frames_per_s": fps, "requests": REQUESTS, "batch": BATCH,
                     "latency_ms": [t * 1e3 for t in lat]}
    log(f"resnet18_cifar int8: {fps:.1f} frames/s, request latency mean "
        f"{sum(lat) / len(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms")
    reset_counts()
    serve(resnet.RESNET8, graphs.resnet8_graph(), 1, "resnet8")

    # device busy share over one request
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            executor.execute(g18, params, xs[0], mode="int8", act_scales=scales)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        # kernel rows only: operator rows repeat their kernels' time
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(r[1] for r in rows) / 1e3
        rows.sort(key=lambda r: -r[1])
        detail["profile"] = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                             "top": [{"name": k[:80], "ms": v / 1e3, "calls": c}
                                     for k, v, c in rows[:15]]}
        log(f"profile of one request: wall {wall * 1e3:.3f} ms (under the "
            f"profiler), kernels {busy:.3f} ms, {len(rows)} kernel names")
        for k, v, c in rows[:8]:
            log(f"  {v / 1e3:9.3f} ms  x{c:<4d} {k[:70]}")
    except Exception as exc:  # the profiler is optional here
        detail["profile"] = f"not measured: {exc!r}"
        log(f"profile: not measured ({exc!r})")

    # ---- 4. kernel timings at the path's shapes ----------------------------
    conv_fn = _build.load("imc_conv2d", "imc_conv2d_launch", conv2d._ARGTYPES)
    mvm_fn = _build.load("imc_mvm", "imc_mvm_launch", mvm_mod._ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def conv_launcher(qx, qw, sx, sw, bias, s, pads):
        B, H, W, cin = qx.shape
        k, _, _, cout = qw.shape
        ho = (H + pads[0] + pads[1] - k) // s + 1
        wo = (W + pads[2] + pads[3] - k) // s + 1
        wp = pack_weight(qw)
        out = torch.empty((B, ho, wo, cout), device=dev)
        args = (qx.data_ptr(), wp.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                bias.data_ptr(), out.data_ptr(), B, H, W, cin, ho, wo, cout, k,
                s, pads[0], pads[2], k * k * cin, wp.shape[1],
                int(cin % 4 == 0 and qx.data_ptr() % 4 == 0), stream)
        return lambda: _build.check(conv_fn(*args), "imc_conv2d")

    conv_rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "wrapper_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "bound_ms": 0.0}
    for shape in distinct:
        B, H, W, cin, cout, k, s, padding = shape
        qx, qw, sx, sw, bias, pads = conv_inputs[shape]
        n = path_convs.count(shape)
        ho, wo = layers.conv_out_hw(H, W, k, s, padding)
        ms = cuda_time_ms(conv_launcher(qx, qw, sx, sw, bias, s, pads), 20)
        wrapper_ms = cuda_time_ms(lambda: imc_conv2d(
            qx, qw, sx, sw, bias, stride=s, pads=pads), 20)
        plain_ms = cuda_time_ms(lambda: ref.conv2d_ref(
            qx, qw, sx, sw, bias, stride=s, pads=pads), 5, warmup=1)
        n_bytes = (B * H * W * cin + k * k * cin * cout + 4 + 8 * cout
                   + 4 * B * ho * wo * cout)
        n_ops = 2 * B * ho * wo * k * k * cin * cout
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        conv_rows.append({"shape": list(shape), "per_request": n, "ms": ms,
                          "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bytes": n_bytes, "ops": n_ops})
        tot["ms"] += n * ms
        tot["wrapper_ms"] += n * wrapper_ms
        tot["plain_ms"] += n * plain_ms
        tot["bound_ms"] += n * b_ms
        tot["bytes_ms"] += n * n_bytes / HBM_BYTES_PER_S * 1e3
        tot["ops_ms"] += n * n_ops / INT8_OPS_PER_S * 1e3
        log(f"  conv {shape} x{n}: kernel {ms:.4f} ms, wrapper {wrapper_ms:.4f}"
            f" ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    detail["imc_conv2d"] = conv_rows

    M, K, N = fc_shape
    qx, qw, sx, sw, bias = mvm_inputs[fc_shape]
    out = torch.empty((M, N), device=dev)
    mvm_args = (qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                bias.data_ptr(), out.data_ptr(), M, K, N, stream)
    mvm_ms = cuda_time_ms(lambda: _build.check(mvm_fn(*mvm_args), "imc_mvm"),
                          50)
    mvm_wrapper_ms = cuda_time_ms(lambda: imc_mvm(qx, qw, sx, sw, bias), 50)
    mvm_plain_ms = cuda_time_ms(lambda: ref.imc_mvm_ref(qx, qw, sx, sw, bias),
                                20)
    # torch._int_mm is the one PyTorch call for the integer product; it
    # needs M > 16 and K, N multiples of 8
    mvm_library_ms = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        mvm_library_ms = cuda_time_ms(lambda: torch._int_mm(qx, qw), 50)
    mvm_bound, mvm_by = bound_ms(M * K + K * N + 4 + 8 * N + 4 * M * N,
                                 2 * M * N * K)
    detail["imc_mvm"] = {"shape": list(fc_shape), "ms": mvm_ms,
                         "wrapper_ms": mvm_wrapper_ms, "plain_ms": mvm_plain_ms,
                         "bound_ms": mvm_bound, "bound_by": mvm_by,
                         "library_ms": mvm_library_ms}
    log(f"  mvm {fc_shape} x1: kernel {mvm_ms:.4f} ms, wrapper "
        f"{mvm_wrapper_ms:.4f} ms, plain {mvm_plain_ms:.4f} ms, bound "
        f"{mvm_bound:.6f} ms ({mvm_by}), library {mvm_library_ms}")
    log(f"per request: imc_conv2d kernels {tot['ms']:.4f} ms (wrappers "
        f"{tot['wrapper_ms']:.4f} ms), plain {tot['plain_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms (bytes {tot['bytes_ms']:.4f} ms, ops "
        f"{tot['ops_ms']:.4f} ms)")
    detail["imc_conv2d_per_request"] = tot
    detail["card"] = card
    detail["device"] = torch.cuda.get_device_name(0)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=2))

    kernels = [
        {"name": "imc_conv2d", "route": "cuda",
         "source": "src/repro_torch/csrc/imc_conv2d.cu",
         "replaces": "src/repro/kernels/conv2d.py:56",
         "launches": counts18[0], "max_abs_err": err["imc_conv2d"],
         "ms": tot["ms"], "plain_ms": tot["plain_ms"],
         "bound_ms": tot["bound_ms"],
         "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
         "library_ms": None},
        {"name": "imc_mvm", "route": "cuda",
         "source": "src/repro_torch/csrc/imc_mvm.cu",
         "replaces": "src/repro/kernels/imc_mvm.py:69",
         "launches": counts18[1], "max_abs_err": err["imc_mvm"],
         "ms": mvm_ms, "plain_ms": mvm_plain_ms, "bound_ms": mvm_bound,
         "bound_by": mvm_by, "library_ms": mvm_library_ms},
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
