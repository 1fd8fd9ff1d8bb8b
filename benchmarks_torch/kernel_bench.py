"""Kernel micro-benchmarks on the card: the reference's cases, then the
served paths' own.

Counterpart of ``benchmarks.kernel_bench``, which times its jnp oracles
on the host and prints TPU roofline estimates.  The same cases here:
``imc_mvm`` at (M, K, N) = (256, 512, 512), (1024, 1024, 1024) and (128,
4096, 4096) with sx 0.1 and sw 0.01, and flash attention at (B, H, S,
hd) = (2, 8, 1024, 128) and (1, 8, 4096, 128) in f32, causal.

On the card (the default), each case launches the hand-written CUDA
kernel through ``repro_torch.kernels.ops`` and holds its output against
the plain version in ``kernels.ref`` (``torch.equal`` for ``imc_mvm``,
``ref.check_flash`` for f32 flash: max |d| <= 2e-4), then times, with
CUDA events over launches back to back after a warm-up: the kernel, the
plain version, and the one PyTorch call that computes the same function,
as a yardstick the port never calls (``torch._int_mm``, the int32 product
without the requant; ``scaled_dot_product_attention`` in f32, named by
the backend it ran).  The bound is the larger of the bytes the case must
move (inputs once, output once) over ``launch.roofline.HBM_BW`` and its
operations over the peak for their type: ``PEAK_INT8_OPS`` for the INT8
product; for f32 flash, 4 hd FLOP a key-query pair (its causal mask
leaves S (S + 1) / 2 pairs a head) in one pass at the peak of the
instance that serves it, ``PEAK_TF32_FLOPS`` for the f32 tensor-core
instance (both cases: hd 128) and ``PEAK_F32_FLOPS`` for the CUDA cores
(wider heads).  The tensor-core instance's split arithmetic does 2.25x
that one pass.  ``launches`` counts the kernel's launches in the case,
and ``instances`` those of each flash instance.

After the reference's five cases come the port's own (``port.*`` keys,
:func:`served_cases`): the kernels of the two served paths at the shapes
those paths give them, built from the configs and the graph.  bf16 flash
at each distinct attention layer of a 4 x 2,048 prefill of
granite-moe-3b-a800m, of a 4 x 3,072 one of recurrentgemma-9b (its 2,048
window) and of a 4 x 2,048 one of gemma3-1b (its 512 window and its
global layers), K/V at their KV heads, in the (B, S, heads, hd) layout
the projections pass; every distinct conv of ResNet-18-CIFAR at batch
256 and its fc.  :func:`time_case` is the one implementation of a port
case; ``chip_smoke.py``'s phases 5, 9, 14 and 15 call it at their paths'
shapes too.  Each case is held against its plain version first
(``torch.equal``; flash by ``kernels.ref.check_flash``, as phase 6
checks), the wrapper's launches must all be on the instance the dispatch
rule names, and it records ``kernel_us`` (warm, back to back),
``cold_us`` (each launch timed alone after a write of ``FLUSH_BYTES``,
over 4x the 50 MB L2, so none of its inputs is cached), for the INT8
kernels ``graph_us`` (the launch replayed from a CUDA graph: no host
gaps) and ``wrapper_us`` (through the wrapper, which packs the conv's
weights on every call); the INT8 times but the wrapper's are of the
kernel module's raw launch (``conv_launcher``, ``mvm_launcher``: weights
packed once, uncounted), itself held to the plain version and to the
rule's instance.  Then ``plain_us``, ``library_us`` (bf16 SDPA with K/V
repeated to H heads outside the timed call, its backend named; none for
the INT8 kernels, with the reason), and the bound: bf16 flash by
:func:`flash_bf16_work` at ``PEAK_FLOPS``.  ``path_launches`` is the
case's launches a prefill or a request on its path;
``port.path.resnet18_int8`` and ``port.path.granite_prefill`` sum
launches x µs of each column over their path's cases.

With ``--device cpu`` only the plain versions run, timed on the host
clock, and no card field is written; the port cases run there only
where the caller passes stand-ins (``main(port=...)``): at the served
widths the plain flash is too slow for a host.  A missing card is an
error unless the caller asks for the CPU.

Writes ``artifacts/bench_torch/kernel_bench.json`` under the reference's
keys (``imc_mvm.MxKxN``, ``flash.BxHxSxhd``), then the ``port.*`` keys.

Usage:
  python -m benchmarks_torch.kernel_bench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv2d, flash_attention as fa, ops, ref
from repro_torch.kernels import imc_mvm as mvm_mod
from repro_torch.kernels.conv2d import conv_launcher, imc_conv2d
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.imc_mvm import imc_mvm, mvm_launcher
from repro_torch.launch.roofline import (HBM_BW, PEAK_F32_FLOPS, PEAK_FLOPS,
                                         PEAK_INT8_OPS, PEAK_TF32_FLOPS)
from repro_torch.models.cnn.layers import conv_out_hw, conv_pads

from .common import csv_line, dump

MVM_SHAPES = ((256, 512, 512), (1024, 1024, 1024), (128, 4096, 4096))
FLASH_SHAPES = ((2, 8, 1024, 128), (1, 8, 4096, 128))
SX, SW = 0.1, 0.01

#: the served prefills whose flash launches the port cases time: arch,
#: prompt width, path.  Batch ``SERVE_B``: ``chip_smoke.py`` phases 8 and
#: 14-15 serve batches of 4, and 3,072 is recurrentgemma's longest prompt
#: there (its 2,048 window masks).
SERVE_B = 4
FLASH_SERVED = (("granite-moe-3b-a800m", 2048, "granite_prefill"),
                ("recurrentgemma-9b", 3072, "recurrentgemma_prefill"),
                ("gemma3-1b", 2048, "gemma3_prefill"))
#: the CNN path's request: ResNet-18-CIFAR, 256 frames
CNN_BATCH = 256
CNN_PATH = "resnet18_int8"
#: the paths whose port cases are summed under ``port.path.<path>``
PATH_SUMS = (CNN_PATH, "granite_prefill")
#: bytes written before each L2-cold launch: over 4x the H100's 50 MB L2
FLUSH_BYTES = 512 * 2**20


class PortCase(NamedTuple):
    """A served kernel at the shape its path gives it.  ``shape``: flash
    (B, H, KV, S, hd, window or None); conv (B, H, W, Cin, Cout, k,
    stride, padding); mvm (M, K, N).  ``path_launches``: its launches a
    prefill or a request of ``path``."""
    key: str
    kind: str
    shape: tuple
    path: str
    path_launches: int


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


def cold_us(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn()`` with a cold L2: before each call a
    write of ``flush`` (over 4x the L2) evicts its inputs, and each call is
    timed by its own event pair."""
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters * 1e3


def graph_us(fn, launches: int = 20) -> float:
    """Device time of one ``fn(stream)`` (a launch on the CUDA stream handle
    it is given) from a CUDA graph of ``launches`` calls: no host gaps."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        st = torch.cuda.current_stream().cuda_stream
        for _ in range(launches):
            fn(st)
    return cuda_us(g.replay, 5) / launches


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


def mvm_work(M: int, K: int, N: int, bias: bool) -> Tuple[int, int]:
    """(bytes, operations) of ``imc_mvm``: int8 qx and qw, the f32 scales
    (and bias) read once, the f32 output written once; 2 M K N."""
    return (M * K + K * N + 4 + 4 * N * (2 if bias else 1) + 4 * M * N,
            2 * M * K * N)


def conv_work(shape) -> Tuple[int, int]:
    """(bytes, operations) of ``imc_conv2d`` at (B, H, W, Cin, Cout, k,
    stride, padding): int8 x and w, sx, sw and the bias read once, the f32
    output written once; 2 MACs' worth a tap of each output channel."""
    B, H, W, cin, cout, k, s, padding = shape
    ho, wo = conv_out_hw(H, W, k, s, padding)
    return (B * H * W * cin + k * k * cin * cout + 4 + 8 * cout
            + 4 * B * ho * wo * cout, 2 * B * ho * wo * k * k * cin * cout)


def flash_bf16_work(B: int, H: int, KV: int, S: int, hd: int,
                    window: Optional[int] = None) -> Tuple[int, int, int]:
    """(key-query pairs, bytes, operations) of causal bf16 flash: q at H
    heads and k, v at KV heads read once in bf16, the f32 (B, H, S, hd)
    output written once; 4 hd FLOP for each pair the causal mask and the
    window leave (a row i keeps min(i + 1, window) keys)."""
    w = S if window is None else min(window, S)
    pairs = B * H * (w * (w + 1) // 2 + (S - w) * w)
    return pairs, 2 * B * S * hd * (H + 2 * KV) + 4 * B * H * S * hd, \
        4 * hd * pairs


def flash_bound(B, H, S, hd):
    """The bound of causal f32 flash at (B, H, S, hd): q, k, v and the
    output once, or one pass of 4 hd FLOP a key-query pair at the peak of
    the instance that serves hd in f32."""
    pairs = B * H * S * (S + 1) / 2          # unmasked key-query pairs
    if fa.instance(torch.float32, hd) == fa.TENSOR_CORE_F32:
        peak, name = PEAK_TF32_FLOPS, "PEAK_TF32_FLOPS"
    else:
        peak, name = PEAK_F32_FLOPS, "PEAK_F32_FLOPS"
    return bound(4.0 * 4 * B * H * S * hd, 4.0 * hd * pairs, peak, name)


def sdpa_backend(q, k, v, mask=None) -> str:
    """The backend ``scaled_dot_product_attention`` ran for these inputs
    (causal, or under the boolean ``mask``), from the names of the kernels
    one call launched."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       is_causal=mask is None)
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for tag, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient"),
                         ("cutlass", "efficient")):
        if tag in names:
            return backend
    return "math"


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


def flash_key(arch, B, H, KV, S, hd, window):
    return (f"port.flash_bf16.{arch}.{B}x{H}x{KV}x{S}x{hd}."
            f"{'causal' if window is None else f'w{window}'}")


def conv_key(B, H, W, cin, cout, k, s, padding):
    return f"port.imc_conv2d.{B}x{H}x{W}x{cin}x{cout}.k{k}s{s}"


def flash_cases(cfg, B: int, S: int, path: str):
    """bf16 flash at each distinct window of ``cfg``'s first segment (a
    window as wide as the prompt is none), for a (B, S) prefill of
    ``path``, each with its launches a prefill."""
    windows = cfg.segments[0].windows()
    cases = []
    for w in sorted(set(windows)):
        shape = (B, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd,
                 None if w >= S else w)
        cases.append(PortCase(flash_key(cfg.name, *shape), "flash_bf16", shape,
                              path, windows.count(w)))
    return cases


def cnn_cases(g, batch: int, path: str = CNN_PATH):
    """Each distinct conv of the graph ``g`` at ``batch`` frames, then its
    fc (mvm) nodes, each with its launches a request."""
    convs = conv_shapes(g, batch)
    cases = [PortCase(conv_key(*shape), "imc_conv2d", shape, path,
                      convs.count(shape))
             for shape in sorted(set(convs), key=convs.index)]
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind.value == "mvm":
            M, K, N = batch, n.meta["cin_kk"], n.meta["cout"]
            cases.append(PortCase(f"port.imc_mvm.{M}x{K}x{N}", "imc_mvm",
                                  (M, K, N), path, 1))
    return cases


def served_cases():
    """The port cases at the served shapes: ``flash_cases`` of each
    ``FLASH_SERVED`` prefill, then ``cnn_cases`` of ResNet-18-CIFAR at
    ``CNN_BATCH``."""
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import graphs
    cases = []
    for arch, S, path in FLASH_SERVED:
        cases += flash_cases(get_config(arch), SERVE_B, S, path)
    return cases + cnn_cases(graphs.resnet18_graph(), CNN_BATCH)


def rule_instance(case: PortCase) -> str:
    """The instance the dispatch rule names for a port case (inputs
    16-byte aligned, as fresh allocations are)."""
    if case.kind == "flash_bf16":
        return fa.instance(torch.bfloat16, case.shape[4])
    if case.kind == "imc_conv2d":
        return conv2d.conv_instance(case.shape[3], case.shape[4], True)
    return mvm_mod.mvm_instance(case.shape[1], True)


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
    rec["bound_us"], rec["bound"], rec["bound_constant"] = bound(
        *mvm_work(M, K, N, bias=False), PEAK_INT8_OPS, "PEAK_INT8_OPS")
    return rec


def zero_flash_counts():
    flash_attention.launches = 0
    flash_attention.instance_launches = dict.fromkeys(
        flash_attention.instance_launches, 0)


def flash_case(B, H, S, hd, dev, gen, iters):
    q, k, v = (torch.randn((B, H, S, hd), generator=gen, device=dev)
               for _ in range(3))
    plain = lambda: ref.flash_attention_ref(q, k, v)  # noqa: E731
    if dev.type == "cpu":
        return {"plain_us": host_us(plain, iters)}
    zero_flash_counts()
    err, _ = ref.check_flash(ops.attention(q, k, v), q, k, v, True, None, None,
                         str((B, H, S, hd)))
    rec = {"kernel_us": cuda_us(lambda: ops.attention(q, k, v), iters),
           "plain_us": cuda_us(plain, max(iters // 10, 2)),
           "library_us": cuda_us(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True), iters),
           "library": f"scaled_dot_product_attention f32 "
                      f"({sdpa_backend(q, k, v)})",
           "launches": flash_attention.launches,
           "instances": {n: c for n, c in
                         flash_attention.instance_launches.items() if c},
           "max_abs_err": err,
           "check": f"max |d| <= {ref.FLASH_F32_TOL}", "matches_plain": True}
    rec["bound_us"], rec["bound"], rec["bound_constant"] = flash_bound(
        B, H, S, hd)
    return rec


def plan(hd: int) -> str:
    """The plan of the bf16 flash instance serving ``hd``: the wgmma
    instance's padded width or the tensor-core instance's steps."""
    if fa.instance(torch.bfloat16, hd) == fa.WGMMA:
        return f"wgmma width {fa.wg_width(hd)}"
    return f"{fa.tc_steps(hd)} steps"


def _launched(case, by_instance, launches):
    """The port case's launches by instance, which must all be on the
    instance the dispatch rule names."""
    ran = {n: c for n, c in by_instance.items() if c}
    if ran != {rule_instance(case): launches}:
        raise AssertionError(f"{case.key}: launches by instance {ran}, the "
                             f"rule names {rule_instance(case)}")
    return ran


def bound_fields(n_bytes, n_ops, peak, peak_name) -> dict:
    """A port case's bound (``bound``) with its two times, µs."""
    us, by, const = bound(n_bytes, n_ops, peak, peak_name)
    return {"bound_us": us, "bound": by, "bound_constant": const,
            "bytes_us": n_bytes / HBM_BW * 1e6, "ops_us": n_ops / peak * 1e6}


def port_flash_case(case, dev, gen, iters, flush):
    B, H, KV, S, hd, window = case.shape
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for n in (H, KV, KV))

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=True, window=window)
    if dev.type == "cpu":
        return {"plain_us": host_us(plain, iters)}

    def call():
        return ops.attention(q, k, v, causal=True, window=window)
    zero_flash_counts()
    err, err16 = ref.check_flash(call(), q, k, v, True, window, None, case.key)
    qc = q.contiguous()
    kx = k.repeat_interleave(H // KV, dim=1).contiguous()
    vx = v.repeat_interleave(H // KV, dim=1).contiguous()
    mask = None
    if window is not None:
        idx = torch.arange(S, device=dev)
        d = idx[:, None] - idx[None, :]
        mask = (d >= 0) & (d < window)

    def sdpa():
        return F.scaled_dot_product_attention(qc, kx, vx, attn_mask=mask,
                                              is_causal=mask is None)
    rec = {"kernel_us": cuda_us(call, iters),
           "cold_us": cold_us(call, iters, flush),
           "plain_us": cuda_us(plain, max(iters // 10, 2)),
           "library_us": cuda_us(sdpa, iters),
           "library": f"scaled_dot_product_attention bf16, K/V repeated to "
                      f"{H} heads ({sdpa_backend(qc, kx, vx, mask)})"}
    rec.update(launches=flash_attention.launches,
               instances=_launched(case, flash_attention.instance_launches,
                                   flash_attention.launches),
               plan=plan(hd), max_abs_err=err, max_abs_err_bf16=err16,
               check=f"max |d| <= {ref.FLASH_F32_TOL} (f32 plain), <= "
                     f"{ref.FLASH_BF16_TOL} (bf16 plain)", matches_plain=True)
    _, n_bytes, n_ops = flash_bf16_work(B, H, KV, S, hd, window)
    rec.update(bound_fields(n_bytes, n_ops, PEAK_FLOPS, "PEAK_FLOPS"))
    return rec


def _int8_inputs(gen, dev, x_shape, w_shape, cout):
    def rand_int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    return (rand_int8(x_shape), rand_int8(w_shape), torch.full((), 0.04,
                                                               device=dev),
            torch.rand((cout,), generator=gen, device=dev) * 0.1 + 1e-3,
            torch.randn((cout,), generator=gen, device=dev))


def _int8_case(case, dev, iters, flush, counted, launcher, wrapper, plain):
    """An INT8 port case on the card: the wrapper ``wrapper()`` (counted by
    ``counted``, the wrapper function) and the raw launch (``launcher()``:
    the kernel module's, weights prepared once, uncounted) each held to the
    plain version with ``torch.equal``, the raw launch on the instance the
    rule names; then the raw launch timed warm, cold and from a CUDA graph,
    the wrapper and the plain version."""
    counted.launches = 0
    counted.launches_by_instance = dict.fromkeys(counted.launches_by_instance,
                                                 0)
    want = plain()
    launch, out, instance = launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch(stream)
    for label, got in (("kernel", wrapper()), ("raw launch", out)):
        if not torch.equal(got, want):
            raise AssertionError(f"{case.key}: {label} != plain, max |d| "
                                 f"{(got - want).abs().max().item()}")
    if instance != rule_instance(case):
        raise AssertionError(f"{case.key}: the raw launch resolves "
                             f"{instance}, the rule names "
                             f"{rule_instance(case)}")
    rec = {"kernel_us": cuda_us(lambda: launch(stream), iters),
           "cold_us": cold_us(lambda: launch(stream), iters, flush),
           "graph_us": graph_us(launch),
           "wrapper_us": cuda_us(wrapper, iters),
           "plain_us": cuda_us(plain, max(iters // 10, 2))}
    rec.update(launches=counted.launches,
               instances=_launched(case, counted.launches_by_instance,
                                   counted.launches),
               raw_instance=instance, max_abs_err=0.0, check="torch.equal",
               matches_plain=True)
    return rec


def port_conv_case(case, dev, gen, iters, flush):
    B, H, W, cin, cout, k, s, padding = case.shape
    qx, qw, sx, sw, bias = _int8_inputs(gen, dev, (B, H, W, cin),
                                        (k, k, cin, cout), cout)
    pads = conv_pads(H, W, k, s, padding)

    def plain():
        return ref.conv2d_ref(qx, qw, sx, sw, bias, stride=s, pads=pads)
    if dev.type == "cpu":
        return {"plain_us": host_us(plain, iters)}

    def wrapper():
        return imc_conv2d(qx, qw, sx, sw, bias, stride=s, pads=pads)
    rec = _int8_case(case, dev, iters, flush, imc_conv2d,
                     lambda: conv_launcher(qx, qw, sx, sw, bias, stride=s,
                                           pads=pads), wrapper, plain)
    rec.update(library_us=None, library="none: no int8 convolution in PyTorch")
    rec.update(bound_fields(*conv_work(case.shape), PEAK_INT8_OPS,
                            "PEAK_INT8_OPS"))
    return rec


def port_mvm_case(case, dev, gen, iters, flush):
    M, K, N = case.shape
    qx, qw, sx, sw, bias = _int8_inputs(gen, dev, (M, K), (K, N), N)

    def plain():
        return ref.imc_mvm_ref(qx, qw, sx, sw, bias)
    if dev.type == "cpu":
        return {"plain_us": host_us(plain, iters)}

    def wrapper():
        return imc_mvm(qx, qw, sx, sw, bias)
    rec = _int8_case(case, dev, iters, flush, imc_mvm,
                     lambda: mvm_launcher(qx, qw, sx, sw, bias), wrapper, plain)
    # torch._int_mm, the one PyTorch call for the integer product, needs
    # M > 16 and K, N multiples of 8
    needs = [c for c, ok in (("M > 16", M > 16), ("K % 8 = 0", K % 8 == 0),
                             ("N % 8 = 0", N % 8 == 0)) if not ok]
    if needs:
        rec.update(library_us=None,
                   library=f"none: torch._int_mm needs {', '.join(needs)}")
    else:
        rec.update(library_us=cuda_us(lambda: torch._int_mm(qx, qw), iters),
                   library="torch._int_mm (int32 product, no requant)")
    rec.update(bound_fields(*mvm_work(M, K, N, bias=True), PEAK_INT8_OPS,
                            "PEAK_INT8_OPS"))
    return rec


PORT_RUNNERS = {"flash_bf16": port_flash_case, "imc_conv2d": port_conv_case,
                "imc_mvm": port_mvm_case}
#: the columns a path sum adds up, launches x µs
SUM_FIELDS = ("kernel_us", "cold_us", "graph_us", "wrapper_us", "plain_us",
              "library_us", "bound_us")


def flush_buffer(dev):
    """The buffer ``cold_us`` writes before each launch (none on the CPU)."""
    if dev.type != "cuda":
        return None
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)


def time_case(case, dev, gen, iters: int = 20, flush=None) -> dict:
    """A served kernel case: on the card its check, launches by instance,
    times (warm, cold, from a graph, through the wrapper, plain, library)
    and bound; on the CPU the plain version's host time.  The one
    implementation of a port case: the kernel bench runs it, and so do
    ``chip_smoke.py``'s phases at their paths' shapes."""
    rec = PORT_RUNNERS[case.kind](case, dev, gen, iters, flush)
    rec.update(path=case.path, path_launches=case.path_launches)
    return rec


def path_sum(cases, out):
    """Σ path launches x µs of each column over ``cases`` (one path).  A
    column some case has as None (no library call) sums to None; one no
    case has is left out.  The bound is the sum of the cases' bounds;
    ``bound`` says which of the summed byte and operation times is the
    larger."""
    rec = {"cases": [c.key for c in cases],
           "path_launches": sum(c.path_launches for c in cases)}
    for field in SUM_FIELDS + ("bytes_us", "ops_us"):
        vals = [out[c.key].get(field) for c in cases]
        if any(field in out[c.key] for c in cases):
            rec[field] = None if None in vals else sum(
                c.path_launches * v for c, v in zip(cases, vals))
    if rec.get("bytes_us") is not None and rec.get("ops_us") is not None:
        rec["bound"] = ("bytes" if rec["bytes_us"] >= rec["ops_us"]
                        else "operations")
    return rec


def time_path(cases, dev, gen, iters: int = 20):
    """``time_case`` of each of one path's ``cases`` on ``dev``:
    (records by key, their ``path_sum``)."""
    flush = flush_buffer(dev)
    recs = {c.key: time_case(c, dev, gen, iters, flush) for c in cases}
    return recs, path_sum(cases, recs)


def port_row(key, rec) -> str:
    """A port case's or a path sum's columns, µs, for a log line."""
    return f"{key:<58s}" + "".join(_fmt(rec.get(f)) for f in SUM_FIELDS)


def _fmt(x):
    return f"{x:10.2f}" if x is not None else f"{'-':>10s}"


def main(device: str = "cuda", iters: int = 20, mvm_shapes=MVM_SHAPES,
         flash_shapes=FLASH_SHAPES, port=None) -> dict:
    """Run the reference's cases, then the port cases ``port`` (default:
    :func:`served_cases` on the card, none on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel bench: no CUDA device (pass --device cpu "
                           "to time the plain versions on the host)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"kernel bench: device {device!r}, want cuda or cpu")
    if port is None:
        port = served_cases() if dev.type == "cuda" else ()
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
                  f"{rec.get('instances', rec['launches'])}; {rec['library']}")
            csv_line(name, rec["kernel_us"],
                     f"bound={rec['bound_us']:.2f}us,{rec['bound']}-bound")
        else:
            print(f"{name:<22s} {'-':>10s} {rec['plain_us']:10.2f}")
            csv_line(name, rec["plain_us"], "plain")
        out[name] = rec

    flush = flush_buffer(dev)
    if port:
        print(f"{'port case':<58s}" + "".join(
            f"{f[:-3]:>10s}" for f in SUM_FIELDS) + "  x path")
    for case in port:
        rec = time_case(case, dev, gen, iters, flush)
        if card is not None:
            rec["card"] = card
            csv_line(case.key, rec["kernel_us"],
                     f"cold={rec['cold_us']:.2f}us,bound="
                     f"{rec['bound_us']:.2f}us,{rec['bound']}-bound")
        else:
            csv_line(case.key, rec["plain_us"], "plain")
        print(port_row(case.key, rec) + f"  x{case.path_launches} "
              f"{rec.get('bound', '')} {rec.get('instances', '')} "
              f"{rec.get('library', '')}")
        out[case.key] = rec
    for path in PATH_SUMS:
        members = [c for c in port if c.path == path]
        if members:
            rec = out[f"port.path.{path}"] = path_sum(members, out)
            print(port_row(f"port.path.{path}", rec)
                  + f"  {rec['path_launches']} launches a "
                    f"{'request' if path == CNN_PATH else 'prefill'}")
    path = dump("kernel_bench", out)
    print(f"artifact: {path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
