#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a nonzero exit:

1. the card's name and power limit; build every kernel in
   ``src/repro_torch/csrc`` with nvcc (one process per source, in
   parallel) and print the build time and ptxas resource lines, and the
   registers and spill bytes of each flash tensor-core instance and of
   each INT8 instance (the serving path's flash instance, the 4-step and
   16-step flash instances of the other families and the ResNet path's
   INT8 instances must not spill);
2. hold the INT8 kernels' C dispatch rules against their Python mirrors,
   then each kernel against its plain PyTorch version on the card with
   ``torch.equal``: every ResNet-18-CIFAR conv shape at batch 256, the fc
   shape, ragged shapes, Cin 16, 24 and 48, Cout 130, an input 1 byte off
   16-byte alignment, and all-+-127 operands at K = 2,304; each check
   logs the instance that ran it, which must be the one the rule names;
   then each op's kernel route (``quantized_matmul``, ``quantized_conv2d``,
   ``attention``) must refuse an input that requires grad;
3. placement, the paper's half of the path: the ResNet-18 graph that
   phase 4 executes is scheduled by lblp, wb, rr and rd on 8 IMC + 4 DPU
   PUs and 128 frames of each simulated on the IMCE model under the
   ``exact`` and ``periodic`` engines (rate, latency, mean utilization,
   host seconds); LBLP must have the best rate and latency within 0.1%.
   Then lblp-r replicates ResNet-8 on 12 + 6 PUs and lblp-mt co-places
   ResNet-8 and ResNet-18 at the README's open-loop rates (printed).
   Then the rest of the paper's tier, all on the host: the YOLOv8n graph
   (built by the port) placed by the same four schedulers on 16 IMC + 8
   DPU PUs, 48 simulated frames under both engines, LBLP's rate at least
   WB's; an ``ElasticSession`` on ResNet-18 over 8 + 4 PUs losing two IMC
   PUs and getting one back (the degradation curve), and an ``lblp-r``
   session on ResNet-8 over 12 + 6 PUs losing a PU that holds only
   replicas, which must recover by ``replica-absorb``; the serving control
   plane playing the README's trace twice under each engine, whose two
   audits must be equal (sha256 printed); and gemma3-1b split into 4
   pipeline stages (boundaries and imbalance);
4. the main path: ResNet-18-CIFAR at full width (random parameters from
   seed 0), calibrated, serving 8 requests of 256 frames of 32x32x3
   through ``executor.execute(..., mode="int8")``; the launch counters
   must read 20 conv and 1 mvm launches per request, by instance 19 on
   the conv's cp.async staging and 1 (the stem) on its gather staging,
   and the logits must match the same executor run on CPU copies (the
   plain path); then ResNet-8 once the same way;
5. timings with CUDA events at the path's shapes (kernel launched back to
   back from the host, the same launches replayed from a CUDA graph,
   wrapper, plain version, bound), end-to-end frames/s and request
   latency, and the device's busy share over one request from
   ``torch.profiler``;
5b. YOLOv8n at full width and 640x640 in float (parameters from a CPU
   generator seeded 0, TF32 off): 2 frames on the card against CPU copies
   (the plain path), raw and decoded, max |d| <= 1e-3 of max |raw| on the
   raw outputs; then 8 requests of 16 frames (frames/s, request latency
   on the host clock ending in a synchronise), one request under
   ``torch.profiler`` (busy share, top rows) and the request's bound (its
   conv FLOPs at the f32 peak);
6. the flash-attention kernel against its plain version: gemma3-1b's
   prefill shapes (B=4, H=4, MQA, S=2048, hd=288) in bf16 and f32, with
   the 512 window and global, and ragged shapes (S = 1000, 300, 100, 1;
   hd 16/64/100/128/288/320; softcap; non-causal; GQA), then the other
   families' prefill shapes in bf16 (hd 64 GQA 24/8; hd 64 non-causal
   at S = 1,500; hd 256 MQA with a 2,048 window at S = 4,096; hd 256 MQA
   at S = 512; a ragged hd 200 on the 16-step instance); each check logs
   the instance that ran it (bf16 within the register plan on the tensor
   cores, f32 and wider bf16 on the CUDA cores), and the Python mirror of
   the dispatch rule is held against the C entry's;
7. gemma3-1b at full width and one window period of depth (6 layers: 5
   local, 1 global), bf16 weights from a CPU generator seeded 0: prefill
   of a 640-token prompt and 4 greedy decode steps on the card against the
   same port on the CPU (the plain path); the greedy tokens must agree at
   every step whose CPU top-2 margin exceeds twice its max |d|, and at
   least one step must be so compared;
8. the LM main path: 26-layer gemma3-1b (random bf16 weights, seed 0, on
   the card) serving 8 requests of 1024-2048 prompt tokens, 32 new tokens
   each, through the port's ``Server``; the flash launch counter must read
   26 per prefill, all on the tensor-core instance; prefill and decode
   rates, time to first token and decode-step latency;
9. the flash kernel's time per prefill of (4, 2048) summed over the 26
   layers at their windows, beside its bound, its plain version and
   ``scaled_dot_product_attention`` (the yardstick only), and the device
   busy share over one prefill and one decode step;
10. (T1) one training step of gemma3-1b at full width cut to 2 layers
   (one 512-window, one global), bf16 weights from a CPU generator seeded
   0, one batch of 1 x 256 tokens from the data pipeline, on the card
   against the same port on the CPU: loss, gradient global norm, each
   leaf's max |dg| against its max |g|, and the parameters after one
   ``adamw.apply``, each within its stated limit, all finite;
11. (T2) gemma3-1b at full width and depth (26 layers, 1.009 B
   parameters) through ``make_train_step``: sequence 4096, global batch
   8 in 4 microbatches of 2, one warm step and 3 timed on one fixed batch
   (host clock ending in a synchronise), tokens/s, MFU against 6 N tokens
   at the bf16 peak, peak device memory, one step under
   ``torch.profiler`` (device time by kernel class); finite losses, the
   last below the first, and no kernel launched (the training path is
   plain PyTorch, as in the reference);
12. (T3) ``examples/train_lm.py``'s ~100M stablelm geometry through the
   port's ``train()``: batch 8 x 256, 300 steps, checkpoints every 50
   into a temporary directory (loss must fall), restore and save timed;
   then an interrupted pair (150 steps, then 300), which must resume from
   150 with its next loss within 10%; 0 retries and 0 rollbacks in every
   run; then one step of that model under ``torch.profiler``.

13. the other LM families at full width and cut depth, card against the
   CPU with phase 7's gate (5% of max |logit|, tokens compared where the
   CPU's top-2 margin exceeds twice the step's max |d|): granite-moe (2
   layers, 640 tokens; also how many (token, layer) top-k expert sets
   differ between the two), falcon-mamba (2 layers, 256 tokens),
   recurrentgemma (one hybrid3 super-block and one rec layer, 640
   tokens), whisper-small (2 + 2 layers, 1,500 frames, 64 tokens) and
   paligemma (2 layers, 256 prefix + 128 tokens), each prefill and 8
   greedy decode steps;
14. this slice's main path: granite-moe-3b-a800m at full width and depth
   (32 layers, random bf16 weights from seed 0) serving 8 requests of
   1024-2048 tokens, 32 new each, through ``Server``: 32 flash launches
   a prefill, all on the tensor-core instance; prefill and decode rates,
   time to first token, step latency, peak memory; one prefill and one
   decode step under ``torch.profiler`` by kernel class (GEMMs, flash,
   the MoE dispatch's gather/scatter/sort/scan glue); the flash kernel's
   time per prefill against its bound, its plain version and SDPA;
15. the other families at full width: falcon-mamba-7b (64 layers) and
   recurrentgemma-9b (38 layers; 4 requests of 2,048-3,072 tokens, so
   its 2,048 window masks) through ``Server`` with 0 and 12 flash
   launches a prefill; whisper-small (4 x 1,500 frames, 64 tokens, 12
   non-causal and 12 causal launches), paligemma-3b (4 x (256 + 256),
   18 launches) and qwen3-moe-235b-a22b cut to 1 layer (~470 GB in bf16
   at full depth) through the step functions, 32 decode steps (4 for
   qwen3), finite logits;
16. one training step at full width, 2 layers, 1 x 256 tokens, card
   against CPU with T1's limits, for granite-moe (the backward through
   the dispatch's gathers) and falcon-mamba (through the scan); no
   kernel may launch.
17. this slice's main path, the sharded serving steps: granite-moe at
   full width and depth (phase 14's weights and first 4 prompts,
   left-padded to 4 x 2,048) through ``make_prefill_step`` and
   ``make_decode_step`` unsharded, then on a real one-rank NCCL process
   group (``make_host_mesh()``) with parameters, batch and cache placed by
   ``sharding`` as DTensors under ``activation_mesh``: 32 tensor-core
   flash launches a prefill (run shard by shard through ``local_map``), 32
   greedy decode steps whose tokens must equal the unsharded run's; max
   |logit d|, prefill and decode-step times, peak memory;
18. the dry run (``python -m repro_torch.launch.dryrun``) of gemma3-1b and
   granite-moe at every shape on the fake 16x16 mesh, started as two
   subprocesses (no card visible) before phase 1 and collected here: each
   supported cell must end ``ok``; per cell the per-device peak, FLOPs
   and collective bytes by kind, each beside the reference's dry run of
   the same cell (``tests/data/dryrun_reference_pod16x16.json``, made by
   ``tests/data/make_dryrun_reference.py``: there is no jax here) and the
   port / reference ratio (the peak also against the reference's less
   XLA:CPU's f32 copies of its bf16 arguments), and
   ``launch.roofline``'s row (model estimates under H100 constants, not
   measurements);
19. ``examples/torch/serve_lm.py`` and ``schedule_and_run_cnn.py`` on the
   card as subprocesses: each must exit 0 and report kernel launches;
20. this slice's path, the port's benchmark harness: ``python -m
   benchmarks_torch.run fig2 fig3 table1 fig4 yolo kernels`` in a
   subprocess must exit 0; the paper's suites run on the host, and the
   kernel bench launches ``imc_mvm`` at the reference's three shapes and
   f32 flash at its two on the card (each case sets the kernel's launch
   count to 0 before it runs and reports it after: it must be nonzero),
   each case equal to its plain version (``torch.equal``; max |d| <=
   2e-4); the table of kernel, plain, library and bound times is printed
   with the card's name and power limit.

Detail goes to ``chiprun_out/chip_smoke.json``.  The line before the last
is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
The script needs a CUDA device and the repository's ``src/``: without
either it exits nonzero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit),
# kept in one place: the port's roofline.
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_F32_FLOPS as F32_FLOPS_PER_S,
    PEAK_FLOPS as BF16_FLOPS_PER_S, PEAK_INT8_OPS as INT8_OPS_PER_S)

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


def ptxas_report(text: str) -> dict:
    """Per kernel function in an ``nvcc -Xptxas -v`` log: registers,
    stack frame, spill stores and spill loads (bytes)."""
    import re
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


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


def graph_time_ms(fn, launches: int = 20) -> float:
    """Device time of one ``fn(stream)`` (a launch on the CUDA stream handle
    it is given) from a CUDA graph of ``launches`` calls: no host gaps."""
    import torch
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        st = torch.cuda.current_stream().cuda_stream
        for _ in range(launches):
            fn(st)
    return cuda_time_ms(g.replay, 5) / launches


def int8_ptxas(libs, path_instances):
    """Registers and spill bytes of every INT8 instance from the build
    logs; an instance on the ResNet path must not spill."""
    from repro_torch.kernels import conv2d, imc_mvm as mvm_mod
    rows = {}
    for name, kernel, insts in (
            ("imc_conv2d", "imc_conv2d_kernel", conv2d.INSTANCES),
            ("imc_mvm", "imc_mvm_kernel", mvm_mod.INSTANCES)):
        report = ptxas_report(Path(f"{libs[name]}.log").read_text())
        for inst in insts:
            vec = int(inst.startswith("cp_async"))
            tag = (f"ILi{inst.split('_n')[1]}ELb{vec}E" if "_n" in inst
                   else f"ILb{vec}E")
            found = [r for fn, r in report.items() if kernel in fn and tag in fn]
            key = f"{name}/{inst}"
            if len(found) != 1:
                raise AssertionError(f"ptxas: no single entry for {key}: {found}")
            r = rows[key] = found[0]
            spills = r.get("spill_stores", 0) + r.get("spill_loads", 0)
            on_path = key in path_instances
            log(f"ptxas INT8 instance {key}{' (path)' if on_path else ''}: "
                f"{r.get('registers')} registers, {r.get('spill_stores')} bytes "
                f"spill stores, {r.get('spill_loads')} bytes spill loads")
            if on_path and spills:
                raise AssertionError(f"ptxas: the path's instance {key} spills")
    return rows


def int8_rule_checks():
    """The C dispatch rules of the INT8 kernels against their mirrors."""
    from repro_torch.kernels import _build, conv2d, imc_mvm as mvm_mod
    conv_rule = _build.load("imc_conv2d", "imc_conv2d_instance",
                            [ctypes.c_int] * 3)
    for cin in (1, 3, 5, 8, 16, 24, 32, 48, 64, 128, 256):
        for cout in (1, 10, 32, 33, 64, 65, 128, 130, 256):
            for aligned in (0, 1):
                want = conv2d.INSTANCES.index(
                    conv2d.conv_instance(cin, cout, bool(aligned)))
                if conv_rule(cin, cout, aligned) != want:
                    raise AssertionError(f"conv dispatch: C rule and mirror "
                                         f"differ at {(cin, cout, aligned)}")
    mvm_rule = _build.load("imc_mvm", "imc_mvm_instance", [ctypes.c_int] * 2)
    for k in (1, 8, 15, 16, 24, 32, 129, 256, 512):
        for aligned in (0, 1):
            want = mvm_mod.INSTANCES.index(mvm_mod.mvm_instance(k, bool(aligned)))
            if mvm_rule(k, aligned) != want:
                raise AssertionError(f"mvm dispatch: C rule and mirror differ "
                                     f"at {(k, aligned)}")
    log("check INT8 dispatch: conv_instance and mvm_instance agree with the C "
        "rules")


def conv_check(qx, qw, sx, sw, bias, stride, pads, label, err):
    """The conv kernel against its plain version with ``torch.equal``; the
    instance that ran must be the one the rule names.  Folds the measured
    max |kernel - plain| into ``err["imc_conv2d"]`` and returns the
    instance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.conv2d import conv_instance, imc_conv2d
    before = dict(imc_conv2d.launches_by_instance)
    got = imc_conv2d(qx, qw, sx, sw, bias, stride=stride, pads=pads)
    want = ref.conv2d_ref(qx, qw, sx, sw, bias, stride=stride, pads=pads)
    torch.cuda.synchronize()
    ran = [n for n, c in imc_conv2d.launches_by_instance.items()
           if c != before[n]]
    rule = conv_instance(qx.shape[3], qw.shape[3], qx.data_ptr() % 16 == 0)
    if ran != [rule]:
        raise AssertionError(f"imc_conv2d {label}: ran {ran}, the rule names "
                             f"{rule}")
    if got.shape != want.shape:
        raise AssertionError(f"imc_conv2d {label}: shape {tuple(got.shape)}, "
                             f"plain {tuple(want.shape)}")
    d = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"imc_conv2d != plain at {label}: max |d| {d}")
    err["imc_conv2d"] = max(err["imc_conv2d"], d)
    log(f"check imc_conv2d {label} [{rule}]: torch.equal")
    return rule


def grad_guard_checks(dev):
    """Each op's kernel route refuses an input that requires grad (the
    CUDA kernels have no backward) and launches nothing."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import imc_conv2d
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.imc_mvm import imc_mvm
    before = (imc_conv2d.launches, imc_mvm.launches, flash_attention.launches)
    sw = torch.ones(8, device=dev, requires_grad=True)
    qx = torch.ones((4, 16), dtype=torch.int8, device=dev)
    qw = torch.ones((16, 8), dtype=torch.int8, device=dev)
    q = torch.ones((1, 1, 4, 16), device=dev, requires_grad=True)
    calls = {
        "quantized_matmul": lambda: ops.quantized_matmul(qx, qw, 0.1, sw),
        "quantized_conv2d": lambda: ops.quantized_conv2d(
            qx.view(1, 2, 2, 16), qw.view(1, 1, 16, 8), 0.1, sw),
        "attention": lambda: ops.attention(q, q, q),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log(f"check {name} on the card: refuses an input that requires "
                f"grad")
        else:
            raise AssertionError(f"{name}: no error for an input that "
                                 f"requires grad")
    if (imc_conv2d.launches, imc_mvm.launches,
            flash_attention.launches) != before:
        raise AssertionError("grad guard: a kernel launched")


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


def to_device(tree, dev):
    """A parameter tree of dicts and lists with its tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it: model name, vendor and
    the number of logical CPUs this process may use."""
    import os
    info = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, val = line.partition(":")
            info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    return (f"model name {info.get('model name', 'unknown')}, "
            f"{info.get('vendor_id', 'unknown vendor')}, "
            f"{len(os.sched_getaffinity(0))} logical CPUs")


PLACE_ALGS = ("lblp", "wb", "rr", "rd")
PLACE_FLEET = (8, 4)            # the paper's Fig. 3 / Table I fleet
PLACE_FRAMES = 128
MT_RATES = {"resnet8": 30.0, "resnet18_cifar": 1000.0}   # README's open loop


def schedule_and_simulate(g18):
    """Phase 3: the paper's half of the path.  Schedule ``g18`` with the
    four paper schedulers on 8 IMC + 4 DPU PUs, simulate 128 frames of
    each on the IMCE model under the ``exact`` and ``periodic`` engines
    and hold LBLP to the paper's claim (best rate and latency within
    0.1%); then replicate ResNet-8 with lblp-r on 12 + 6 PUs and co-place
    ResNet-8 and ResNet-18 with lblp-mt at the README's open-loop rates
    (printed only).  The rates and latencies are outputs of the IMCE cost
    model, not speeds of this machine; the seconds are host time.
    Returns ``(lblp assignment, record)``."""
    import math
    from repro_torch.core import (CostModel, IMCESimulator, MultiTenantGraph,
                                  get_scheduler, make_pus, make_simulator,
                                  schedule_replicated)
    from repro_torch.models.cnn import graphs
    cm = CostModel()
    fleet = make_pus(*PLACE_FLEET)
    rec = {"graph": g18.name, "nodes": len(g18), "fleet": list(PLACE_FLEET),
           "frames": PLACE_FRAMES, "host_cpu": host_cpu(),
           "units": "IMCE model: frames/s, seconds; host_s: host seconds",
           "schedulers": {}}
    assignments = {}
    for alg in PLACE_ALGS:
        t = time.perf_counter()
        a = get_scheduler(alg, cm).schedule(g18, fleet)
        row = {"schedule_host_s": time.perf_counter() - t,
               "mapping": {str(k): v for k, v in sorted(a.mapping.items())}}
        for engine in ("exact", "periodic"):
            t = time.perf_counter()
            res = make_simulator(g18, cm, engine=engine).run(
                a, frames=PLACE_FRAMES)
            row[engine] = {"rate": res.rate, "latency": res.latency,
                           "mean_utilization": res.mean_utilization,
                           "bound_interval": res.bound_interval,
                           "host_s": time.perf_counter() - t}
        assignments[alg] = a
        rec["schedulers"][alg] = row
        ex, pe = row["exact"], row["periodic"]
        log(f"place {alg} on {PLACE_FLEET[0]}+{PLACE_FLEET[1]} PUs: simulated "
            f"(IMCE model) rate {ex['rate']:.1f} fps, latency "
            f"{ex['latency'] * 1e3:.4f} ms, mean utilization "
            f"{ex['mean_utilization'] * 100:.1f}% (periodic: {pe['rate']:.1f} "
            f"fps, {pe['latency'] * 1e3:.4f} ms); host s: schedule "
            f"{row['schedule_host_s']:.4f}, exact {ex['host_s']:.4f}, "
            f"periodic {pe['host_s']:.4f}")
    for engine in ("exact", "periodic"):
        res = {k: v[engine] for k, v in rec["schedulers"].items()}
        best_rate = max(r["rate"] for r in res.values())
        best_lat = min(r["latency"] for r in res.values())
        if not (res["lblp"]["rate"] >= 0.999 * best_rate
                and res["lblp"]["latency"] <= 1.001 * best_lat):
            raise AssertionError(f"place: LBLP misses the paper's claim under "
                                 f"{engine}: {res}")
    lblp = rec["schedulers"]["lblp"]["exact"]
    wb = rec["schedulers"]["wb"]["exact"]
    log(f"place: LBLP best rate and latency of {', '.join(PLACE_ALGS)} under "
        f"both engines; LBLP / WB rate {lblp['rate'] / wb['rate']:.3f}, WB / "
        f"LBLP latency {wb['latency'] / lblp['latency']:.3f} (host "
        f"{rec['host_cpu']})")

    t = time.perf_counter()
    g_r, a_r = schedule_replicated(graphs.resnet8_graph(), make_pus(12, 6), cm)
    res_r = IMCESimulator(g_r, cm).run(a_r, frames=PLACE_FRAMES)
    rec["replicated"] = {"replicas": {str(k): v for k, v in
                                      a_r.meta["replicas"].items()},
                         "nodes": len(g_r), "rate": res_r.rate,
                         "latency": res_r.latency,
                         "host_s": time.perf_counter() - t}
    log(f"place lblp-r resnet8 on 12+6 PUs: replicas {a_r.meta['replicas']} "
        f"({len(g_r)} nodes), simulated rate {res_r.rate:.1f} fps, latency "
        f"{res_r.latency * 1e3:.4f} ms")

    t = time.perf_counter()
    mt = MultiTenantGraph.union([graphs.resnet8_graph(), graphs.resnet18_graph()])
    a_mt = get_scheduler("lblp-mt", cm).schedule(mt, fleet)
    res_mt = make_simulator(mt, cm).run(a_mt, frames=64, rates=MT_RATES)
    rec["multi_tenant"] = {
        "rates": MT_RATES, "host_s": time.perf_counter() - t,
        "tenants": {k: {"rate": m.rate, "latency": m.latency,
                        "utilization_share": m.utilization_share}
                    for k, m in res_mt.tenants.items()}}
    for k, m in res_mt.tenants.items():
        log(f"place lblp-mt tenant {k} (offered {MT_RATES[k]} fps): simulated "
            f"rate {m.rate:.2f} fps, latency {m.latency * 1e3:.4f} ms, share "
            f"{m.utilization_share * 100:.1f}%")
    nums = [res_r.rate, res_r.latency] + [
        x for m in res_mt.tenants.values() for x in (m.rate, m.latency)]
    if not all(math.isfinite(x) and x > 0 for x in nums):
        raise AssertionError(f"place: non-finite or non-positive figures {nums}")
    return assignments["lblp"], rec


YOLO_FLEET = (16, 8)            # the paper's §V.C fleet
YOLO_FRAMES = 48
ELASTIC_FLEET = (8, 4)
ELASTIC_FAILS = (1, 2)          # two IMC PUs fail, then the first rejoins
ABSORB_FLEET = (12, 6)
SERVING_FLEET = (8, 4)
PARTITION_ARCH, PARTITION_STAGES = "gemma3-1b", 4


def place_yolov8n():
    """Phase 3: the YOLOv8n graph, built by the port, placed by the four
    paper schedulers on 16 IMC + 8 DPU PUs and 48 frames of each simulated
    on the IMCE model under ``exact`` and ``periodic``.  The gate is the
    paper's claim for this model: LBLP's rate at least WB's.  Returns the
    record (IMCE figures; host seconds)."""
    from repro_torch.core import CostModel, get_scheduler, make_pus, make_simulator
    from repro_torch.models.cnn import graphs
    cm = CostModel()
    t = time.perf_counter()
    g = graphs.yolov8n_graph()
    rec = {"nodes": len(g), "fleet": list(YOLO_FLEET), "frames": YOLO_FRAMES,
           "build_host_s": time.perf_counter() - t, "schedulers": {}}
    for alg in PLACE_ALGS:
        t = time.perf_counter()
        a = get_scheduler(alg, cm).schedule(g, make_pus(*YOLO_FLEET))
        row = {"schedule_host_s": time.perf_counter() - t}
        for engine in ("exact", "periodic"):
            t = time.perf_counter()
            res = make_simulator(g, cm, engine=engine).run(a, frames=YOLO_FRAMES)
            row[engine] = {"rate": res.rate, "latency": res.latency,
                           "mean_utilization": res.mean_utilization,
                           "host_s": time.perf_counter() - t}
        rec["schedulers"][alg] = row
        ex, pe = row["exact"], row["periodic"]
        log(f"place yolov8n {alg} on {YOLO_FLEET[0]}+{YOLO_FLEET[1]} PUs: "
            f"simulated (IMCE model) rate {ex['rate']:.3f} fps, latency "
            f"{ex['latency'] * 1e3:.4f} ms, mean utilization "
            f"{ex['mean_utilization'] * 100:.1f}% (periodic: {pe['rate']:.3f} "
            f"fps, {pe['latency'] * 1e3:.4f} ms); host s: schedule "
            f"{row['schedule_host_s']:.4f}, exact {ex['host_s']:.4f}, "
            f"periodic {pe['host_s']:.4f}")
    for engine in ("exact", "periodic"):
        lblp = rec["schedulers"]["lblp"][engine]["rate"]
        wb = rec["schedulers"]["wb"][engine]["rate"]
        if not lblp >= wb:
            raise AssertionError(f"place yolov8n: LBLP rate {lblp} < WB rate "
                                 f"{wb} under {engine}")
    ratio = (rec["schedulers"]["lblp"]["exact"]["rate"]
             / rec["schedulers"]["wb"]["exact"]["rate"])
    log(f"place yolov8n: LBLP rate >= WB rate under both engines (LBLP / WB "
        f"{ratio:.3f})")
    return rec


def elastic_sessions():
    """Phase 3: an ``ElasticSession`` on ResNet-18 over 8 + 4 PUs loses
    two IMC PUs and gets the first back (the degradation curve); an
    ``lblp-r`` session on ResNet-8 over 12 + 6 PUs loses a PU that holds
    only replicas and must recover by replica absorption.  Returns the
    record (IMCE figures)."""
    from repro_torch.core import make_pus
    from repro_torch.core.elastic import ElasticSession
    from repro_torch.models.cnn import graphs
    t = time.perf_counter()
    fleet = make_pus(*ELASTIC_FLEET)
    sess = ElasticSession(graphs.resnet18_graph(), fleet)
    for pu in ELASTIC_FAILS:
        sess.fail(pu)
    sess.join(next(p for p in fleet if p.pu_id == ELASTIC_FAILS[0]))
    curve = sess.degradation_curve()
    rec = {"fleet": list(ELASTIC_FLEET), "fails": list(ELASTIC_FAILS),
           "curve": [list(c) for c in curve],
           "recovery": [e.recovery for e in sess.history]}
    steps = (["start"] + [f"fail {pu}" for pu in ELASTIC_FAILS]
             + [f"join {ELASTIC_FAILS[0]}"])
    for step, (n, rate, lat), e in zip(steps, curve, sess.history):
        log(f"elastic resnet18 {step}: {n} PUs, simulated (IMCE model) rate "
            f"{rate:.3f} fps, latency {lat * 1e3:.4f} ms ({e.recovery})")

    sess = ElasticSession(graphs.resnet8_graph(), make_pus(*ABSORB_FLEET),
                          algorithm="lblp-r")
    mapping = dict(sess.assignment.mapping)
    replicas = {m for ms in sess.serving_graph.replica_groups().values()
                for m in ms}
    only_replicas = [pid for pid in sorted(set(mapping.values()))
                     if all(n in replicas for n, p in mapping.items() if p == pid)]
    if not only_replicas:
        raise AssertionError("elastic: no PU of the lblp-r session holds only "
                             "replicas")
    before = sess.history[-1]
    ev = sess.fail(only_replicas[0])
    if ev.recovery != "replica-absorb":
        raise AssertionError(f"elastic: failing PU {only_replicas[0]} gave "
                             f"{ev.recovery!r}, not 'replica-absorb'")
    if any(ev.mapping[n] != mapping[n] for n in ev.mapping):
        raise AssertionError("elastic: replica absorption moved a node")
    rec["absorb"] = {"fleet": list(ABSORB_FLEET), "only_replicas": only_replicas,
                     "failed_pu": only_replicas[0], "recovery": ev.recovery,
                     "rate_before": before.rate, "rate": ev.rate,
                     "latency": ev.latency}
    rec["host_s"] = time.perf_counter() - t
    log(f"elastic resnet8 lblp-r on {ABSORB_FLEET[0]}+{ABSORB_FLEET[1]} PUs: "
        f"PUs holding only replicas {only_replicas}; fail {only_replicas[0]} -> "
        f"{ev.recovery}, simulated rate {before.rate:.3f} -> {ev.rate:.3f} "
        f"fps (both sessions: host {rec['host_s']:.3f} s)")
    return rec


def readme_trace():
    """The README's three-event serving trace."""
    from repro_torch.core import SLO, TraceEvent
    return [
        TraceEvent("arrive", tenant="cam-0", model="resnet8",
                   slo=SLO(min_rate=300.0, max_latency=0.05)),
        TraceEvent("arrive", tenant="bulk-0", model="resnet18",
                   slo=SLO(min_rate=400.0), weight=2.0),
        TraceEvent("fail", pu_id=3),
    ]


def serving_plane():
    """Phase 3: the serving control plane plays the README's trace on
    8 + 4 PUs twice under each engine; the two audits of one engine must
    be equal as strings.  Returns the record (decisions, audit hashes)."""
    import hashlib
    from repro_torch.core import ServingControlPlane, make_pus
    from repro_torch.models.cnn import graphs
    models = {"resnet8": graphs.resnet8_graph(),
              "resnet18": graphs.resnet18_graph()}
    rec = {}
    for engine in ("exact", "periodic"):
        audits = []
        for _ in range(2):
            t = time.perf_counter()
            plane = ServingControlPlane(make_pus(*SERVING_FLEET), models,
                                        engine=engine)
            plane.play(readme_trace())
            audits.append(plane.audit_json())
            host_s = time.perf_counter() - t
        if audits[0] != audits[1]:
            raise AssertionError(f"serving: two audits under {engine} differ")
        sha = hashlib.sha256(audits[0].encode()).hexdigest()
        rec[engine] = {"sha256": sha, "host_s": host_s, "probes": plane.probes,
                       "decisions": [(d.index, d.event, d.action, d.reason)
                                     for d in plane.decisions]}
        for d in plane.decisions:
            log(f"serving {engine} {d.index} {d.event} {d.action}: {d.reason}")
        log(f"serving {engine}: audits equal, sha256 {sha}, {plane.probes} "
            f"probes, host {host_s:.3f} s a play")
    return rec


def stage_partition():
    """Phase 3: the LM pipeline-stage partitioner on gemma3-1b over 4
    H100 stages.  Returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline_partition import partition
    plan = partition(get_config(PARTITION_ARCH), PARTITION_STAGES)
    rec = {"arch": PARTITION_ARCH, "stages": PARTITION_STAGES,
           "boundaries": plan.boundaries, "imbalance": plan.imbalance,
           "loads_s": plan.loads, "lblp_bottleneck_s": plan.lblp_bottleneck}
    log(f"partition {PARTITION_ARCH} into {PARTITION_STAGES} stages: "
        f"boundaries {plan.boundaries}, imbalance {plan.imbalance:.6f}")
    return rec


# ---------------------------------------------------------------------------
# YOLOv8n in float on the card (the paper's §V.C model)
# ---------------------------------------------------------------------------

YOLO_HW = 640
YOLO_CHECK_FRAMES = 2
YOLO_REQUESTS = 8
YOLO_BATCH = 16
YOLO_RTOL = 1e-3       # max |card - cpu| <= YOLO_RTOL * max |raw|


def yolo_card_vs_cpu(dev, hw, frames):
    """Phase 5b: YOLOv8n at full width (parameters from a CPU generator
    seeded 0, moved to ``dev``) on ``frames`` images of ``hw`` x ``hw``,
    raw and decoded, on ``dev`` against CPU copies (the plain path).  The
    gate is max |d| <= YOLO_RTOL * max |raw| over the raw outputs.
    Returns ``(parameters on dev, record)``."""
    import torch
    from repro_torch.models.cnn import yolo
    params_cpu = yolo.init(torch.Generator().manual_seed(0), device="cpu")
    params = to_device(params_cpu, dev)
    x = torch.randn((frames, hw, hw, 3), generator=torch.Generator().manual_seed(1))
    t = time.perf_counter()
    raw_cpu = yolo.forward(params_cpu, x, decode=False)
    dec_cpu = yolo.forward(params_cpu, x)
    cpu_s = time.perf_counter() - t
    raw = yolo.forward(params, x.to(dev), decode=False)
    dec = yolo.forward(params, x.to(dev))
    anchors = sum((hw // s) ** 2 for s in yolo.STRIDES)
    want = [(frames, hw // s, hw // s, 4 * yolo.REG_MAX + yolo.NC)
            for s in yolo.STRIDES]
    for out in raw + [dec]:
        if out.device.type != torch.device(dev).type or not torch.isfinite(out).all():
            raise AssertionError(f"yolov8n: output on {out.device} or not finite")
    if [tuple(r.shape) for r in raw] != want or tuple(dec.shape) != (
            frames, anchors, 4 + yolo.NC):
        raise AssertionError(f"yolov8n: shapes {[tuple(r.shape) for r in raw]}, "
                             f"{tuple(dec.shape)}")
    d_raw = max((r.cpu() - c).abs().max().item() for r, c in zip(raw, raw_cpu))
    m_raw = max(c.abs().max().item() for c in raw_cpu)
    d_dec = (dec.cpu() - dec_cpu).abs().max().item()
    m_dec = dec_cpu.abs().max().item()
    log(f"yolov8n {hw}x{hw} x{frames} card vs cpu plain path: raw max |d| "
        f"{d_raw:.3e} (max |raw| {m_raw:.4f}, {d_raw / m_raw:.3e} of it; limit "
        f"{YOLO_RTOL}), decoded max |d| {d_dec:.3e} (max |out| {m_dec:.3f}); "
        f"cpu forward {cpu_s:.2f} s")
    if d_raw > YOLO_RTOL * m_raw:
        raise AssertionError(f"yolov8n: raw outputs differ from the CPU by "
                             f"{d_raw:.3e} > {YOLO_RTOL} x {m_raw:.4f}")
    return params, {"hw": hw, "frames": frames, "raw_max_abs_d": d_raw,
                    "raw_max_abs": m_raw, "decoded_max_abs_d": d_dec,
                    "decoded_max_abs": m_dec, "cpu_forward_s": cpu_s}


def yolo_bound_ms(hw, batch):
    """Least device time of one request: the conv FLOPs of the port's
    deployment graph at ``hw`` over the f32 peak, or the input, output
    and parameter bytes over HBM, whichever is larger."""
    from repro_torch.core.graph import OpKind
    from repro_torch.models.cnn import graphs, yolo
    g = graphs.build_yolov8n_graph({**yolo.YOLOV8N, "image_hw": (hw, hw)})
    convs = [n for n in g.nodes.values() if n.kind == OpKind.CONV]
    flops = batch * sum(n.flops for n in convs)
    anchors = sum((hw // s) ** 2 for s in yolo.STRIDES)
    # a conv node's weight_bytes is its parameter count (1 byte each in
    # the INT8 deployment); the model's parameters are all conv parameters
    n_bytes = 4 * (batch * hw * hw * 3 + batch * anchors * (4 + yolo.NC)
                   + sum(n.weight_bytes for n in convs))
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": n_bytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def yolo_serve(params, dev, hw, n_requests, batch, sync):
    """Phase 5b: serve ``n_requests`` requests of ``batch`` frames through
    ``yolo.forward`` on ``dev`` (decoded output), the host clock around
    each forward ending in ``sync()``.  Returns the record."""
    import torch
    from repro_torch.models.cnn import yolo
    xs = torch.randn((n_requests, batch, hw, hw, 3), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    yolo.forward(params, xs[0])          # warm-up: library handles, allocator
    sync()
    outs, lat = [], []
    t_all = time.perf_counter()
    for r in range(n_requests):
        t = time.perf_counter()
        outs.append(yolo.forward(params, xs[r]))
        sync()
        lat.append(time.perf_counter() - t)
    total = time.perf_counter() - t_all
    for y in outs:
        if y.device.type != torch.device(dev).type or not torch.isfinite(y).all():
            raise AssertionError("yolov8n serve: output off the device or "
                                 "not finite")
    rec = {"hw": hw, "requests": n_requests, "batch": batch,
           "frames_per_s": n_requests * batch / total,
           "latency_ms": [t * 1e3 for t in lat],
           "latency_ms_mean": sum(lat) / len(lat) * 1e3,
           "latency_ms_max": max(lat) * 1e3, **yolo_bound_ms(hw, batch)}
    log(f"yolov8n {hw}x{hw} serve: {n_requests} requests x {batch} frames, "
        f"{rec['frames_per_s']:.1f} frames/s, request latency mean "
        f"{rec['latency_ms_mean']:.3f} ms, max {rec['latency_ms_max']:.3f} ms; "
        f"bound {rec['bound_ms']:.4f} ms a request ({rec['bound_by']}: "
        f"{rec['flops'] / 1e9:.3f} GFLOP at {F32_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s f32)")
    return rec


# ---------------------------------------------------------------------------
# LM serving path (gemma3-1b) and its flash-attention kernel
# ---------------------------------------------------------------------------

FLASH_F32_TOL = 2e-4   # f32 inputs, and bf16 inputs against the f32 upcast
FLASH_BF16_TOL = 2e-2  # bf16 inputs against the plain version in bf16
# Card against CPU at full width: both run the port in bf16, but the card's
# kernel keeps the logits and probabilities in f32 where the CPU's plain
# version rounds the logits to bf16, and cuBLAS and the CPU sum the bf16
# products in other orders.  Each layer moves the logits by a few bf16 ulps
# (2^-8 relative); over 6 layers that stays within 5% of max |logit|.
LM_LOGIT_TOL = 5e-2
LM_PROMPT = 640        # > 512: the local layers' window bites
LM_DECODE_STEPS = 4
SERVE_REQUESTS = 8
SERVE_LENS = (1024, 2048)
SERVE_MAX_NEW = 32
SERVE_MAX_BATCH = 4
PATH_B, PATH_S = 4, 2048


def flash_inputs(gen, dev, B, H, KV, S, hd, dtype, path_layout, scale=1.0):
    """Random q (B,H,S,hd) and k/v (B,KV,S,hd).  With ``path_layout`` they
    are transposed views of (B,S,heads,hd) tensors, as attention.forward
    passes its projections."""
    import torch

    def make(heads):
        shape = (B, S, heads, hd) if path_layout else (B, heads, S, hd)
        t = scale * torch.randn(shape, generator=gen, device=dev)
        t = t.to(dtype)
        return t.transpose(1, 2) if path_layout else t

    return make(H), make(KV), make(KV)


def flash_check(q, k, v, causal, window, softcap, label):
    """Kernel against its plain version on the same inputs; returns the
    tight error (f32 inputs, or bf16 against the f32 upcast).  The
    instance that ran (by its launch count) must be the one the dispatch
    rule names."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    flash_attention = fa.flash_attention
    before = dict(flash_attention.instance_launches)
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    ran = [n for n, c in flash_attention.instance_launches.items()
           if c != before[n]]
    want_inst = (fa.TENSOR_CORE if fa.uses_tensor_cores(q.dtype, q.shape[3])
                 else fa.CUDA_CORE)
    if ran != [want_inst]:
        raise AssertionError(f"flash_attention {label}: ran {ran}, the rule "
                             f"names {want_inst}")
    f32 = [t.float() for t in (q, k, v)]
    want = ref.flash_attention_ref(*f32, causal=causal, window=window,
                                   softcap=softcap)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention {label}: bad output")
    err = (got - want).abs().max().item()
    if err > FLASH_F32_TOL:
        raise AssertionError(f"flash_attention {label}: max |d| {err:.3e} > "
                             f"{FLASH_F32_TOL} against the f32 plain version")
    line = (f"check flash_attention {label} [{ran[0]}]: max |d| {err:.2e} "
            f"(f32 plain)")
    if q.dtype == torch.bfloat16:
        want16 = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                         softcap=softcap)
        err16 = (got - want16).abs().max().item()
        if err16 > FLASH_BF16_TOL:
            raise AssertionError(f"flash_attention {label}: max |d| {err16:.3e}"
                                 f" > {FLASH_BF16_TOL} against the bf16 plain")
        line += f", {err16:.2e} (bf16 plain)"
    log(line)
    return err


#: B, H, KV, S, hd, causal, window, path layout: the other LM families'
#: prefill shapes (granite-moe and qwen3-moe, whisper's non-causal encoder,
#: recurrentgemma's 2,048 window, paligemma's prefix + text) and a ragged
#: case on the 16-step instance
FAMILY_FLASH_SHAPES = [(4, 24, 8, 2048, 64, True, None, True),
                       (4, 12, 12, 1500, 64, False, None, True),
                       (2, 16, 1, 4096, 256, True, 2048, True),
                       (4, 8, 1, 512, 256, True, None, True),
                       (1, 3, 1, 1000, 200, True, None, False)]


def flash_checks(dev, hd_path, local_window):
    """Phase 6: the flash kernel against its plain version at the serving
    path's shapes (both dtypes, window and global) and at ragged ones."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    rule = _build.load("flash_attention", "flash_attention_instance",
                       [ctypes.c_int, ctypes.c_int])
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for hd in (8, 16, 64, 100, 128, 256, 288, 289, 320, 512):
            if rule(code, hd) != int(fa.uses_tensor_cores(dtype, hd)):
                raise AssertionError(f"flash dispatch: the C rule and "
                                     f"uses_tensor_cores differ at {dtype} {hd}")
    log("check flash dispatch: uses_tensor_cores agrees with the C rule")
    gen = torch.Generator(device=dev).manual_seed(7)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for window in (local_window, None):
            qkv = flash_inputs(gen, dev, PATH_B, 4, 1, PATH_S, hd_path, dtype,
                               path_layout=True)
            err = max(err, flash_check(*qkv, True, window, None,
                                       f"path {str(dtype)[6:]} window {window}"))
    ragged = [  # B, H, KV, S, hd, dtype, causal, window, softcap, scale
        (1, 3, 3, 1000, 64, torch.float32, True, None, None, 1.0),
        (3, 5, 5, 100, 16, torch.bfloat16, True, None, None, 1.0),
        (2, 6, 2, 1000, 128, torch.bfloat16, True, 256, None, 1.0),
        (1, 7, 1, 1000, 288, torch.bfloat16, True, 512, None, 1.0),
        (2, 3, 1, 1000, 288, torch.float32, True, 512, None, 1.0),
        (2, 3, 3, 100, 64, torch.float32, False, None, None, 1.0),
        (1, 2, 2, 1000, 128, torch.float32, True, None, 50.0, 3.0),
        (2, 2, 1, 100, 16, torch.float32, False, 32, 50.0, 3.0),
        (1, 1, 1, 1, 16, torch.float32, True, None, None, 1.0),
        # bf16 on the tensor cores: stablelm-1.6b's width with GQA, hd 288
        # with softcap, rows that are not 16-byte aligned (hd 100), S = 1;
        # bf16 wider than the register plan, on the CUDA cores
        (2, 8, 2, 1000, 64, torch.bfloat16, True, None, None, 1.0),
        (1, 4, 1, 1000, 288, torch.bfloat16, True, 512, 2.0, 1.0),
        (1, 2, 2, 300, 100, torch.bfloat16, False, None, None, 1.0),
        (1, 2, 1, 1, 288, torch.bfloat16, True, None, None, 1.0),
        (1, 2, 1, 300, 320, torch.bfloat16, True, 128, None, 1.0),
    ]
    for B, H, KV, S, hd, dtype, causal, window, softcap, scale in ragged:
        qkv = flash_inputs(gen, dev, B, H, KV, S, hd, dtype, path_layout=False,
                           scale=scale)
        label = (f"({B},{H},{KV},{S},{hd}) {str(dtype)[6:]} causal={causal} "
                 f"window={window} softcap={softcap}")
        err = max(err, flash_check(*qkv, causal, window, softcap, label))
    for B, H, KV, S, hd, causal, window, path_layout in FAMILY_FLASH_SHAPES:
        qkv = flash_inputs(gen, dev, B, H, KV, S, hd, torch.bfloat16,
                           path_layout=path_layout)
        label = (f"({B},{H},{KV},{S},{hd}) bfloat16 causal={causal} "
                 f"window={window} ({fa.tc_steps(hd)}-step instance)")
        err = max(err, flash_check(*qkv, causal, window, None, label))
    return err


class RouteMatch:
    """``moe.route`` for a card-against-CPU comparison of an MoE arch.

    An MoE route is a discontinuous function of the router logits: where
    the k-th and (k+1)-th experts' logits lie closer than the card's and
    the CPU's bf16 differences in the router input, the two sides may pick
    different experts, and that token's output moves by a whole expert's
    share (granite-moe at full width: 89 of 1,280 (token, layer) sets, and
    the last position's logits 13.7% apart, in this PR's first card run).
    So the comparison splits in two: the card's call takes the experts of
    the CPU's matching call (same order: ``side("cpu")`` and
    ``side("card")`` say which side runs), with gates from the card's own
    router logits at those experts, and the logit and gradient gates then
    hold every other difference to their limits; and each (token, layer)
    set that the card's own top-k would choose differently must be a near
    tie, the CPU's margin between its k-th and (k+1)-th logit within twice
    the call's max |router logit difference|, else it fails."""

    def __init__(self, real_route, top_k_fn):
        self.real, self.top_k = real_route, top_k_fn
        self.cpu_calls = []
        self.current = "cpu"
        self.differ = self.total = 0
        self.worst_margin_ratio = 0.0

    def side(self, name):
        self.current = name

    def __call__(self, p, x, top_k):
        import torch
        if self.current == "cpu":
            gates, experts = self.real(p, x, top_k)
            logits = (x.to(torch.float32) @ p.w_router).detach()
            self.cpu_calls.append((logits, experts))
            return gates, experts
        cpu_logits, cpu_experts = self.cpu_calls.pop(0)
        logits = x.to(torch.float32) @ p.w_router
        own = self.top_k(logits.detach(), top_k)[1].cpu()
        a = own.reshape(-1, top_k).sort(dim=-1).values
        b = cpu_experts.reshape(-1, top_k).sort(dim=-1).values
        rows = (a != b).any(dim=-1)
        self.total += rows.numel()
        if rows.any():
            flat = cpu_logits.reshape(-1, cpu_logits.shape[-1])
            d = (logits.detach().cpu().reshape(flat.shape) - flat).abs().max().item()
            srt = flat.sort(dim=-1, descending=True).values
            margin = (srt[rows, top_k - 1] - srt[rows, top_k]).max().item()
            self.differ += int(rows.sum())
            self.worst_margin_ratio = max(
                self.worst_margin_ratio, margin / d if d > 0 else float("inf"))
            if margin > 2 * d:
                raise AssertionError(f"moe route: the card picks other experts "
                                     f"where the CPU's k-th margin {margin:.4f} "
                                     f"exceeds twice the router logits' max "
                                     f"|d| {d:.4f}: not a near tie")
        forced = cpu_experts.to(x.device)
        gates = torch.softmax(torch.gather(logits, -1, forced), dim=-1)
        return gates, forced

    def record(self, name):
        log(f"{name}: {self.differ} of {self.total} (token, layer) expert sets "
            f"of the card's own top-k differ from the CPU's, each a near tie "
            f"(worst margin / max |d| {self.worst_margin_ratio:.3f}, limit 2); "
            f"the card followed the CPU's routes")
        return {"route_sets_differing": self.differ, "route_sets": self.total,
                "worst_margin_ratio": self.worst_margin_ratio}


def follow_cpu_routes(cfg):
    """(side callback, RouteMatch or None, restore): for an MoE arch,
    ``moe.route`` becomes a ``RouteMatch`` until ``restore()``."""
    from repro_torch.models.lm import moe
    if not cfg.n_experts:
        return (lambda name: None), None, (lambda: None)
    real = moe.route
    match = RouteMatch(real, moe._top_k)
    moe.route = match

    def restore():
        moe.route = real
    return match.side, match, restore


def lm_card_vs_cpu(cfg, dev, prompt_len, steps, extra=None):
    """Phase 7 (and 13): ``cfg`` (full width, cut depth) with bf16 weights
    from a CPU generator seeded 0, copied to ``dev``; prefill and ``steps``
    decode steps on both, the CPU's greedy tokens fed to both.  ``extra``
    holds CPU tensors of the arch's other inputs (``enc_frames``,
    ``prefix``), copied to ``dev`` likewise.  The greedy tokens
    must agree at every step whose top-2 margin on the CPU exceeds twice
    that step's measured max |d| (there no error of that size can swap
    them), and at least one step must be so compared.  An MoE arch's card
    follows the CPU's routes (``RouteMatch``).  Returns the worst max |d| /
    max |logit| and the number of tokens compared (for MoE also the
    route counts)."""
    import torch
    from repro_torch.models.lm import transformer
    extra = extra or {}
    params_cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         device="cpu")
    params_dev = transformer.tree_map(lambda t: t.to(dev), params_cpu)
    extra_dev = {k: v.to(dev) for k, v in extra.items()}
    toks = torch.randint(0, cfg.vocab, (1, prompt_len),
                         generator=torch.Generator().manual_seed(1))
    n_prefix = extra["prefix"].shape[1] if "prefix" in extra else 0
    s_max = prompt_len + n_prefix + steps
    side, match, restore = follow_cpu_routes(cfg)
    try:
        out = _card_vs_cpu_steps(cfg, params_cpu, params_dev, toks, s_max,
                                 steps, extra, extra_dev, dev, side)
    finally:
        restore()
        if match is not None:       # printed before any failure propagates
            out_routes = match.record(f"lm card vs cpu {cfg.name}")
    if match is not None:
        out.update(out_routes)
    return out


def _card_vs_cpu_steps(cfg, params_cpu, params_dev, toks, s_max, steps, extra,
                       extra_dev, dev, side):
    import torch
    from repro_torch.models.lm import transformer
    t = time.perf_counter()
    side("cpu")
    log_cpu, cache_cpu = transformer.prefill(cfg, params_cpu, toks, s_max, **extra)
    cpu_s = time.perf_counter() - t
    side("card")
    log_dev, cache_dev = transformer.prefill(cfg, params_dev, toks.to(dev), s_max,
                                             **extra_dev)
    worst, compared = 0.0, 0
    for step in range(steps + 1):
        a, b = log_cpu[:, -1].float(), log_dev[:, -1].float().cpu()
        if not torch.isfinite(b).all():
            raise AssertionError(f"lm: non-finite card logits at step {step}")
        lmax = a.abs().max().item()
        dmax = (a - b).abs().max().item()
        rel = dmax / lmax
        top2 = a.topk(2, dim=-1).values[0]
        margin = (top2[0] - top2[1]).item()
        same = bool(a.argmax(-1) == b.argmax(-1))
        gated = margin > 2 * dmax
        log(f"lm card vs cpu step {step}: max |d| {dmax:.4f}, / max |logit| "
            f"{rel:.3e} (max |logit| {lmax:.3f}), top-2 margin {margin:.4f}"
            f"{' > 2 max |d|: compared' if gated else ''}, tokens equal {same}")
        if rel > LM_LOGIT_TOL:
            raise AssertionError(f"lm: card logits differ from the CPU by "
                                 f"{rel:.3e} of max |logit| > {LM_LOGIT_TOL}")
        if gated:
            compared += 1
            if not same:
                raise AssertionError(f"lm: greedy token differs at step {step}")
        worst = max(worst, rel)
        if step == steps:
            break
        tok = a.argmax(-1, keepdim=True)
        side("cpu")
        log_cpu, cache_cpu = transformer.decode(cfg, params_cpu, tok, cache_cpu)
        side("card")
        log_dev, cache_dev = transformer.decode(cfg, params_dev, tok.to(dev),
                                                cache_dev)
    if compared == 0:
        raise AssertionError(f"lm: no greedy token compared in {steps + 1} "
                             f"steps (no top-2 margin exceeded 2 max |d|)")
    return {"worst_rel": worst, "tokens_compared": compared,
            "cpu_prefill_s": cpu_s}


def timed_steps(server, sync):
    """Wrap a server's steps to time each call (host clock, ending in a
    device synchronise) and check its logits; returns the record."""
    import torch
    rec = {"prefill": [], "decode": []}
    pre, dec = server.prefill, server.decode

    def timed(kind, fn, tokens_of):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            sync()
            rec[kind].append((time.perf_counter() - t, tokens_of(*args)))
            if not torch.isfinite(out[0]).all():
                raise AssertionError(f"serve: non-finite logits in {kind}")
            return out
        return call

    server.prefill = timed("prefill", pre, lambda p, b: b["tokens"].numel())
    server.decode = timed("decode", dec, lambda p, tok, c: tok.numel())
    return rec


def lm_serve(cfg, dev, n_requests, lens, max_new, max_batch, sync):
    """Phase 8: the main path.  ``cfg`` through the port's ``Server``, bf16
    weights from a generator on ``dev`` seeded 0, prompts of seeded
    lengths in ``lens``; returns the server (warmed up, steps timed by
    ``timed_steps``), the requests and the timing record.  Serving them is
    left to the caller, which resets the launch counts just before."""
    import numpy as np
    import torch
    from repro_torch.models.lm import transformer
    from repro_torch.runtime.serve_loop import Request, Server
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(0)
    s_max = lens[1] + max_new
    server = Server(cfg, params, max_batch=max_batch, s_max=s_max)
    # warm-up (library handles, allocator) before the counted run
    server.serve([Request(-1, torch.arange(64), max_new=2)])
    sync()
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab, int(n))),
                    max_new=max_new)
            for i, n in enumerate(rng.integers(lens[0], lens[1] + 1, n_requests))]
    rec = timed_steps(server, sync)
    return server, reqs, rec


def flash_timings(dev, cfg, B=None, S=None):
    """Phase 9 (and 14-15): per prefill of (B, S) (default (PATH_B,
    PATH_S)), the kernel, its plain version and SDPA (the yardstick; the
    port never calls it) at each attention layer's window (those of the
    config's first segment), summed over the layers; the bound from this
    run's shapes and masks."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, S = B or PATH_B, S or PATH_S
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = flash_inputs(gen, dev, B, H, KV, S, hd, torch.bfloat16,
                           path_layout=True)
    qc = q.contiguous()
    kx = k.repeat_interleave(H // KV, dim=1).contiguous()
    vx = v.repeat_interleave(H // KV, dim=1).contiguous()
    idx = torch.arange(S, device=dev)
    d = idx[:, None] - idx[None, :]
    windows = cfg.segments[0].windows()
    rows = {}
    for w in sorted(set(windows)):
        window = None if w >= S else w
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                  window=window), 10)
        plain_ms = cuda_time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window), 5, warmup=1)
        band = None if window is None else (d >= 0) & (d < window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qc, kx, vx, attn_mask=band, is_causal=band is None)

        library_ms = cuda_time_ms(sdpa, 10)
        pairs = B * H * int(((d >= 0) & (d < (window or S + 1))).sum())
        n_bytes = 2 * (q.numel() + k.numel() + v.numel()) + 4 * q.numel()
        n_ops = 4 * hd * pairs
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / BF16_FLOPS_PER_S * 1e3
        n = windows.count(w)
        rows[w] = {"window": window, "layers": n, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "pairs": pairs, "bytes": n_bytes,
                   "flop": n_ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"  flash window {window} x{n}: kernel {ms:.4f} ms "
            f"({n_ops / ms / 1e9:.1f} useful TFLOP/s), plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({rows[w]['bound_by']}; "
            f"{pairs} pairs, {n_bytes / 1e6:.1f} MB)")
    tot = {key: sum(r["layers"] * r[key] for r in rows.values())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                       "ops_ms")}
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    tot["per_window"] = list(rows.values())
    log(f"per {cfg.name} prefill ({B}, {S}), {len(windows)} "
        f"attention layers (hd {hd}, {H}/{KV} heads): flash kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({tot['bound_by']})")
    return tot


KERNEL_CLASSES = (("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
                  ("softmax", ("SoftMax",)), ("copy/cast", ("copy",)),
                  ("reduce", ("reduce_kernel",)))


#: the serving profile's classes: the flash kernel, and the MoE dispatch's
#: glue (advanced indexing, gather/scatter, the one-hot, sorts and scans)
SERVE_CLASSES = (("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("flash", ("flash_",)),
                 ("gather/scatter/sort/scan", ("index", "gather", "scatter",
                                               "Sort", "sort", "scan", "Scan",
                                               "cub::")),
                 ("softmax", ("SoftMax",)), ("copy/cast", ("copy",)),
                 ("reduce", ("reduce_kernel",)))


def kernel_classes(rows, classes=KERNEL_CLASSES):
    """Device ms summed by the class of kernel name (``classes``; the rest
    is "elementwise")."""
    out = {name: 0.0 for name, _ in classes}
    out["elementwise"] = 0.0
    for row in rows:
        cls = next((name for name, keys in classes
                    if any(k in row["name"] for k in keys)), "elementwise")
        out[cls] += row["ms"]
    return out


def profile_kernels(fn, top=12):
    """Wall time and device kernel time of ``fn()`` under torch.profiler:
    (wall ms, busy ms, the ``top`` kernel rows by time, all of them if
    ``top`` is None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    return wall * 1e3, busy, [{"name": k[:80], "ms": v / 1e3, "calls": c}
                              for k, v, c in rows[:top]]


# ---------------------------------------------------------------------------
# LM training: gemma3-1b steps, and the repo's ~100M training example
# ---------------------------------------------------------------------------

T1_SEQ = 256
# T1, one training step at full width (2 layers), card against the CPU.
# Both sides run the port in bf16 with f32 logits and f32 moments; they
# round the same bf16 products summed in other orders (cuBLAS against the
# CPU's GEMMs), an ulp or so (2^-8 relative) per op.  On the CPU the
# port's bf16 gradients differ from the reference's by at most 2.2e-2 of a
# leaf's max |g| on the smoke configs (tests/test_torch_train.py); the
# card is held to 5e-2 per leaf, the forward's limit in phase 7.  The
# loss is a mean over 255 tokens, whose errors average out: 1e-2.
T1_LOSS_RTOL = 1e-2
T1_GNORM_RTOL = 5e-2
T1_GRAD_RTOL = 5e-2
# T2, gemma3-1b at full depth: SHAPES["train_4k"]'s sequence, global batch
# cut from 256 to 8 and microbatch from 64 to 2 (4 accumulation slices).
T2_SEQ, T2_BATCH, T2_MICROBATCH = 4096, 8, 2
T2_STEPS = 4           # one warm step, then 3 timed
# T3, the repo's training example (examples/train_lm.py) on the card
T3_STEPS, T3_BATCH, T3_SEQ, T3_CKPT_EVERY = 300, 8, 256, 50
T3_RESUME_RTOL = 0.10  # loss at the first resumed step against the last one


def stablelm_100m():
    """``examples/train_lm.py``'s ~100M geometry (stablelm family, scaled
    down), copied here."""
    import dataclasses
    from repro_torch.configs import Segment, get_config
    return dataclasses.replace(
        get_config("stablelm-1.6b"), name="stablelm-100m", d_model=640,
        n_heads=10, n_kv_heads=10, head_dim=64, d_ff=1792, vocab=32768,
        segments=(Segment("attn", 12),), microbatch=8)


def train_card_vs_cpu(cfg, dev, seq, side=lambda name: None):
    """Phase T1: one batch of 1 x ``seq`` tokens through ``loss_and_grads``
    and one ``adamw.apply`` (warmup 1: lr 3e-4 at step 1), bf16 weights
    from a CPU generator seeded 0 copied to ``dev``, on both.  Compares the
    loss, the gradients' global norm, each leaf's max |dg| against its max
    |g|, and the parameters after the update: at step 1 the update is
    lr * (m/sqrt(v) + wd p) with |m/sqrt(v)| <= 1, so a gradient whose sign
    differs moves a parameter by at most 2 lr more, and the bf16 casts of
    two f32 values that close differ by at most one ulp of the leaf's
    largest |p| (2^-7 max |p|).  Any non-finite value fails."""
    import math
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.lm import model, transformer
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten_with_names, tree_map
    params_cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    batch = make_batch(cfg, ShapeSpec("t1", seq, 1, "train"), 0, device="cpu")
    opt = adamw.AdamWConfig(warmup_steps=1)

    def step(params, batch):
        loss, grads = model.loss_and_grads(cfg, params, batch)
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        new, _, metrics = adamw.apply(opt, params, adamw.init(params), grads)
        return float(loss), grads, new, metrics

    t = time.perf_counter()
    side("cpu")
    cpu = step(params_cpu, batch)
    cpu_s = time.perf_counter() - t
    side("card")
    card = step(params_dev, {k: v.to(dev) for k, v in batch.items()})
    lr = float(cpu[3]["lr"])
    rec = {"loss_cpu": cpu[0], "loss_card": card[0], "cpu_s": cpu_s, "lr": lr,
           "grad_norm_cpu": float(cpu[3]["grad_norm"]),
           "grad_norm_card": float(card[3]["grad_norm"]), "leaves": {}}
    if not (math.isfinite(rec["loss_card"]) and math.isfinite(rec["grad_norm_card"])):
        raise AssertionError(f"train T1: non-finite card loss or norm: {rec}")
    rec["loss_rel"] = abs(rec["loss_card"] - rec["loss_cpu"]) / abs(rec["loss_cpu"])
    rec["grad_norm_rel"] = (abs(rec["grad_norm_card"] - rec["grad_norm_cpu"])
                            / rec["grad_norm_cpu"])
    log(f"train T1 {cfg.name} {cfg.n_layers} layers, 1 x {seq} tokens: loss "
        f"card {rec['loss_card']:.6f} cpu {rec['loss_cpu']:.6f} (rel "
        f"{rec['loss_rel']:.2e}, limit {T1_LOSS_RTOL}); grad norm card "
        f"{rec['grad_norm_card']:.6f} cpu {rec['grad_norm_cpu']:.6f} (rel "
        f"{rec['grad_norm_rel']:.2e}, limit {T1_GNORM_RTOL}); cpu side "
        f"{cpu_s:.1f} s")
    bad = []
    if rec["loss_rel"] > T1_LOSS_RTOL:
        bad.append("loss")
    if rec["grad_norm_rel"] > T1_GNORM_RTOL:
        bad.append("grad norm")
    pairs = zip(tree_flatten_with_names(cpu[1]), tree_flatten_with_names(card[1]),
                tree_flatten_with_names(cpu[2]), tree_flatten_with_names(card[2]))
    for (name, gc), (_, gd), (_, pc), (_, pd) in pairs:
        gd, pd = gd.cpu(), pd.cpu()
        if not (torch.isfinite(gd).all() and torch.isfinite(pd.float()).all()):
            raise AssertionError(f"train T1: non-finite card gradient or "
                                 f"parameter in {name}")
        g_rel = ((gc - gd).abs().max() / gc.abs().max()).item()
        p_d = (pc.float() - pd.float()).abs().max().item()
        # 1.001: m/sqrt(v) is 1 only to f32 rounding
        p_lim = 2 * lr * 1.001 + 2.0 ** -7 * pc.float().abs().max().item()
        moved = (pc != pd).float().mean().item()
        rec["leaves"][name] = {"grad_rel": g_rel, "param_max_d": p_d,
                               "param_limit": p_lim, "param_frac_differ": moved}
        log(f"  {name}: max |dg| / max |g| {g_rel:.2e} (limit {T1_GRAD_RTOL}); "
            f"after adamw max |dp| {p_d:.3e} (limit {p_lim:.3e}), "
            f"{100 * moved:.4f}% of elements differ")
        if g_rel > T1_GRAD_RTOL:
            bad.append(f"{name} grad")
        if p_d > p_lim:
            bad.append(f"{name} param")
    if bad:
        raise AssertionError(f"train T1: card differs from the CPU beyond the "
                             f"limits in {bad}")
    rec["worst_grad_rel"] = max(r["grad_rel"] for r in rec["leaves"].values())
    return rec


def train_steps(cfg, dev, shape, microbatch, n_steps, opt, sync):
    """Phase T2: ``cfg`` with bf16 weights from a generator on ``dev``
    seeded 0 through ``make_train_step`` (``microbatch`` rows a slice);
    ``n_steps`` steps, each timed on the host clock ending in ``sync``, all
    on the data pipeline's batch of step 0, so that a falling loss shows
    the gradients' direction and not the batch-to-batch noise (the
    pipeline's stream is near-uniform over the vocabulary: over 3 steps of
    fresh batches the loss moves less than it varies between batches).
    Every loss must be finite and the last below the first.  Returns the
    record and a closure that runs one more step."""
    import math
    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.lm import model, transformer
    from repro_torch.optim import adamw
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = {"params": params, "opt": adamw.init(params)}
    del params
    step_fn = model.make_train_step(cfg, model.TrainStepConfig(opt=opt),
                                    microbatch=microbatch)
    batch = make_batch(cfg, shape, 0, device=dev)

    def one_step():
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], batch)
        return float(metrics["loss"])

    losses, secs = [], []
    for _ in range(n_steps):
        sync()
        t = time.perf_counter()
        loss = one_step()
        sync()
        secs.append(time.perf_counter() - t)
        losses.append(loss)
        if not math.isfinite(loss):
            raise AssertionError(f"train T2: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train T2: loss did not fall: {losses}")
    return {"losses": losses, "step_s": secs}, one_step


def train_example(cfg, dev, steps, batch, seq, ckpt_every, opt, root, sync):
    """Phase T3: ``examples/train_lm.py`` through the port's ``train()`` on
    ``dev`` with the AdamW config ``opt``: ``steps`` steps with
    checkpoints every ``ckpt_every`` into
    ``root/full`` (the mean of the first 10 losses must exceed that of the
    last 10), and times one restore and one save of its final state; then
    an interrupted pair in ``root/pair``, ``steps // 2`` steps and then
    ``steps``: the second must resume from ``steps // 2`` and its first
    loss lie within ``T3_RESUME_RTOL`` of the first run's last.  Every run
    must report 0 retries and 0 rollbacks (the loop's retry and its NaN
    breaker could hide a failing device step).  Each directory is removed
    once read, so at most one run's checkpoints are on disk."""
    import math
    import shutil
    import statistics
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import ShapeSpec
    from repro_torch.models.lm import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainLoopConfig, train
    shape = ShapeSpec("example", seq, batch, "train")

    def loop(total, sub):
        return TrainLoopConfig(total_steps=total, ckpt_every=ckpt_every,
                               ckpt_dir=str(root / sub), log_every=0, opt=opt)

    def run(total, sub, hook=None):
        rep = train(cfg, shape, loop(total, sub), fault_hook=hook, device=dev)
        if rep.retries or rep.rollbacks:
            raise AssertionError(f"train T3 {sub} to {total}: {rep.retries} "
                                 f"retries, {rep.rollbacks} rollbacks")
        if not all(math.isfinite(x) for x in rep.losses):
            raise AssertionError(f"train T3 {sub} to {total}: non-finite loss")
        return rep

    stamps = []
    full = run(steps, "full", lambda step: stamps.append(time.perf_counter()))
    head = statistics.fmean(full.losses[:10])
    tail = statistics.fmean(full.losses[-10:])
    if not tail < head:
        raise AssertionError(f"train T3: loss did not fall ({head} -> {tail})")
    meta = transformer.init_params(cfg, torch.Generator(), device="meta")
    like = {"params": meta, "opt": adamw.init(meta)}
    sync()
    t = time.perf_counter()
    last, state, _ = ckpt.restore_latest(str(root / "full"), like, dev)
    sync()
    restore_s = time.perf_counter() - t
    shutil.rmtree(root / "full")
    t = time.perf_counter()
    ckpt.save(str(root / "timing"), last, state)
    save_s = time.perf_counter() - t
    shutil.rmtree(root / "timing")
    del state
    half = steps // 2
    first = run(half, "pair")
    second = run(steps, "pair")
    if second.resumed_from != half or second.steps_run != steps - half:
        raise AssertionError(f"train T3: resumed from {second.resumed_from}, "
                             f"ran {second.steps_run} steps")
    jump = abs(second.losses[0] - first.losses[-1]) / first.losses[-1]
    if jump > T3_RESUME_RTOL:
        raise AssertionError(f"train T3: loss {second.losses[0]} at step "
                             f"{half + 1} against {first.losses[-1]} at {half}")
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return {"params": transformer.param_count(cfg), "steps": full.steps_run,
            "first10": head, "last10": tail, "wall_s": full.wall_seconds,
            "step_s_median": statistics.median(gaps),
            "step_s_mean": statistics.fmean(gaps),
            "resumed_from": second.resumed_from,
            "loss_at_half": first.losses[-1], "loss_after": second.losses[0],
            "resume_jump": jump, "restore_s": restore_s, "save_s": save_s,
            "ckpt_step": last,
            "retries": [r.retries for r in (full, first, second)],
            "rollbacks": [r.rollbacks for r in (full, first, second)]}


# ---------------------------------------------------------------------------
# The other LM families (phases 13-16)
# ---------------------------------------------------------------------------

FAMILY_DECODE_STEPS = 8
#: phase 13, card against CPU at full width: arch, layers per segment,
#: encoder layers, prompt tokens, encoder frames
FAMILY_CARD_VS_CPU = (("granite-moe-3b-a800m", (2,), None, 640, 0),
                      ("falcon-mamba-7b", (2,), None, 256, 0),
                      ("recurrentgemma-9b", (1, 1), None, 640, 0),
                      ("whisper-small", (2,), (2,), 64, 1500),
                      ("paligemma-3b", (2,), None, 128, 0))
MAIN_ARCH = "granite-moe-3b-a800m"
#: phase 15 through ``Server``: arch, requests, prompt lengths, new tokens,
#: flash launches a prefill
FAMILY_SERVE = (("falcon-mamba-7b", 4, (1024, 2048), 16, 0),
                ("recurrentgemma-9b", 4, (2048, 3072), 16, 12))
#: phase 15 through the step functions: arch, batch, prompt tokens, decode
#: steps, encoder frames, layers (None: all), flash launches a prefill
FAMILY_STEPS = (("whisper-small", 4, 64, 32, 1500, None, 24),
                ("paligemma-3b", 4, 256, 32, 0, None, 18),
                ("qwen3-moe-235b-a22b", 4, 2048, 4, 0, 1, 1))
T16_ARCHS = ("granite-moe-3b-a800m", "falcon-mamba-7b")


def cut(cfg, *ns, enc=None):
    """``cfg`` with segment i cut to ``ns[i]`` layers and its encoder
    segments to ``enc`` (widths kept)."""
    import dataclasses
    segs = tuple(dataclasses.replace(s, n=n) for s, n in zip(cfg.segments, ns))
    out = dataclasses.replace(cfg, segments=segs)
    if enc is not None:
        out = dataclasses.replace(out, enc_segments=tuple(
            dataclasses.replace(s, n=n) for s, n in zip(cfg.enc_segments, enc)))
    return out


def family_inputs(cfg, batch, frames, gen):
    """The arch's stub inputs besides tokens, random bf16 drawn from
    ``gen`` on its device: encoder frames (batch, frames, D) or an image
    prefix (batch, P, prefix_dim)."""
    import torch
    out = {}
    if cfg.is_encdec():
        out["enc_frames"] = torch.randn((batch, frames, cfg.enc_frame_dim),
                                        generator=gen, device=gen.device)
    if cfg.num_prefix_tokens:
        out["prefix"] = torch.randn((batch, cfg.num_prefix_tokens,
                                     cfg.prefix_dim), generator=gen,
                                    device=gen.device)
    return {k: v.to(torch.bfloat16) for k, v in out.items()}


def zero_counts():
    """Every kernel wrapper's launch counts set to 0."""
    from repro_torch.kernels.conv2d import imc_conv2d
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.imc_mvm import imc_mvm
    for fn in (imc_conv2d, imc_mvm):
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(fn.launches_by_instance, 0)
    flash_attention.launches = 0
    flash_attention.instance_launches = dict.fromkeys(
        flash_attention.instance_launches, 0)


def read_counts():
    from repro_torch.kernels.conv2d import imc_conv2d
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.imc_mvm import imc_mvm
    return {"flash": flash_attention.launches,
            "flash_instances": dict(flash_attention.instance_launches),
            "conv": imc_conv2d.launches, "mvm": imc_mvm.launches}


def check_flash_counts(counts, per_prefill, prefills, label):
    """The path's launches: ``per_prefill`` flash launches a prefill, all on
    the tensor-core instance, and no INT8 kernel."""
    from repro_torch.kernels import flash_attention as fa
    if prefills == 0 or counts["flash"] != per_prefill * prefills:
        raise AssertionError(f"{label}: {counts['flash']} flash launches for "
                             f"{prefills} prefills, want {per_prefill} each")
    if counts["flash_instances"][fa.TENSOR_CORE] != counts["flash"]:
        raise AssertionError(f"{label}: flash launches by instance "
                             f"{counts['flash_instances']}, not all on the "
                             f"tensor cores")
    if counts["conv"] or counts["mvm"]:
        raise AssertionError(f"{label}: the LM path launched an INT8 kernel")


def serve_counted(cfg, dev, n_requests, lens, max_new, max_batch,
                  flash_per_prefill, sync):
    """``cfg`` through ``Server`` (``lm_serve``): the launch counts set to 0
    just before the requests and read just after, the device's peak memory
    over them, each request's tokens checked; returns (server, record)."""
    import torch
    server, reqs, rec = lm_serve(cfg, dev, n_requests, lens, max_new,
                                 max_batch, sync)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats = server.serve(reqs)
    sync()
    counts = read_counts()
    check_flash_counts(counts, flash_per_prefill, stats.prefills, cfg.name)
    for r in reqs:
        if len(r.out_tokens) != max_new or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"serve {cfg.name}: request {r.rid} got "
                                 f"{r.out_tokens}")
    pre_s = sum(t for t, _ in rec["prefill"])
    pre_tok = sum(n for _, n in rec["prefill"])
    dec = [t for t, _ in rec["decode"]]
    dec_tok = sum(n for _, n in rec["decode"])
    out = {
        "requests": len(reqs), "prompt_lens": [int(r.prompt.numel()) for r in reqs],
        "prefills": stats.prefills, "decode_steps": stats.decode_steps,
        "flash_launches": counts["flash"],
        "flash_instances": counts["flash_instances"],
        "wall_s": stats.wall_seconds, "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "prefill_tokens": pre_tok, "prefill_tok_per_s": pre_tok / pre_s,
        "ttft_ms": [t * 1e3 for t, _ in rec["prefill"]],
        "decode_tok_per_s": dec_tok / sum(dec),
        "decode_step_ms_mean": sum(dec) / len(dec) * 1e3,
        "decode_step_ms_max": max(dec) * 1e3}
    log(f"{cfg.name} serve ({cfg.n_layers} layers): {out['requests']} requests "
        f"(prompts {out['prompt_lens']}), {stats.prefills} prefills, "
        f"{stats.decode_steps} decode steps, flash launches {counts['flash']} "
        f"({flash_per_prefill} per prefill; by instance "
        f"{counts['flash_instances']}), wall {stats.wall_seconds:.3f} s, peak "
        f"memory {out['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  prefill {out['prefill_tok_per_s']:.1f} tok/s (padded tokens), time "
        f"to first token {', '.join(f'{t:.1f}' for t in out['ttft_ms'])} ms; "
        f"decode {out['decode_tok_per_s']:.1f} tok/s, step "
        f"{out['decode_step_ms_mean']:.3f} ms mean, "
        f"{out['decode_step_ms_max']:.3f} ms max")
    return server, out


def profile_serving(cfg, params, dev, B, S, top=6):
    """One prefill of (B, S) random tokens and one decode step against its
    cache under ``torch.profiler``: wall, device busy time, device time by
    ``SERVE_CLASSES``, top rows."""
    import torch
    from repro_torch.models.lm import transformer
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))

    def prefill_once():
        return transformer.prefill(cfg, params, toks, S + 1)

    cache = prefill_once()[1]

    def decode_once():      # writes position S of the cache each time
        return transformer.decode(cfg, params, toks[:, :1], cache)

    out = {}
    for name, fn in (("prefill", prefill_once), ("decode", decode_once)):
        fn()
        torch.cuda.synchronize()
        wall, busy, rows = profile_kernels(fn, top=None)
        classes = kernel_classes(rows, SERVE_CLASSES)
        out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "launches": sum(r["calls"] for r in rows),
                     "classes_ms": classes, "top": rows[:top]}
        log(f"profile one {cfg.name} {name} ({B}, {S}): wall {wall:.3f} ms "
            f"(under the profiler), kernels {busy:.3f} ms "
            f"({100 * busy / wall:.1f}% busy) in {out[name]['launches']} "
            f"launches; by class "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in classes.items()))
        for row in rows[:top]:
            log(f"  {row['ms']:9.3f} ms  x{row['calls']:<5d} {row['name'][:70]}")
    return out


def families_card_vs_cpu(dev):
    """Phase 13: each family at full width and cut depth, card against the
    CPU (``lm_card_vs_cpu``'s gate)."""
    import torch
    from repro_torch import configs
    out = {}
    for arch, ns, enc, prompt, frames in FAMILY_CARD_VS_CPU:
        cfg = cut(configs.get_config(arch), *ns, enc=enc)
        extra = family_inputs(cfg, 1, frames, torch.Generator().manual_seed(2))
        t = time.perf_counter()
        rec = lm_card_vs_cpu(cfg, dev, prompt, FAMILY_DECODE_STEPS, extra)
        rec["wall_s"] = time.perf_counter() - t
        out[arch] = rec
        log(f"{arch} {cfg.n_layers} layers, full width"
            f"{f', {frames} frames' if frames else ''}"
            f"{f', {cfg.num_prefix_tokens} prefix' if cfg.num_prefix_tokens else ''}"
            f", {prompt} tokens: card vs cpu within {rec['worst_rel']:.3e} of "
            f"max |logit| (limit {LM_LOGIT_TOL}), {rec['tokens_compared']} "
            f"tokens compared; cpu prefill {rec['cpu_prefill_s']:.1f} s, phase "
            f"{rec['wall_s']:.1f} s")
        torch.cuda.empty_cache()
    return out


def step_path(cfg, dev, batch, prompt, steps, frames, flash_per_prefill, sync):
    """Phase 15 for the archs served through the step functions
    (``make_prefill_step``/``make_decode_step``, as the reference allows for
    encoder frames and image prefixes): weights on ``dev`` from a CUDA
    generator seeded 0, one warm-up prefill, then, with the counts set to
    0, one prefill and ``steps`` greedy decode steps, timed on the host
    clock ending in ``sync``.  Flash launches are split by ``causal`` with
    a counting wrapper around ``ops.attention``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.lm import model, transformer
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    batch_in = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt),
                                        generator=gen, device=dev),
                **family_inputs(cfg, batch, frames, gen)}
    s_max = prompt + cfg.num_prefix_tokens + steps
    prefill = model.make_prefill_step(cfg, s_max)
    decode = model.make_decode_step(cfg)
    prefill(params, batch_in)               # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    by_causal, real = {True: 0, False: 0}, ops.attention

    def counting(q, k, v, **kw):
        by_causal[kw.get("causal", True)] += 1
        return real(q, k, v, **kw)

    ops.attention = counting
    try:
        zero_counts()
        t = time.perf_counter()
        logits, cache = prefill(params, batch_in)
        sync()
        ttft = time.perf_counter() - t
        counts = read_counts()
        secs = []
        for _ in range(steps):
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{cfg.name}: non-finite logits")
            tok = torch.argmax(logits[:, -1:], dim=-1)
            t = time.perf_counter()
            logits, cache = decode(params, tok, cache)
            sync()
            secs.append(time.perf_counter() - t)
    finally:
        ops.attention = real
    if not torch.isfinite(logits).all() or logits.shape != (batch, 1, cfg.vocab):
        raise AssertionError(f"{cfg.name}: bad logits {tuple(logits.shape)}")
    check_flash_counts(counts, flash_per_prefill, 1, cfg.name)
    if cache.cur_pos != prompt + cfg.num_prefix_tokens + steps:
        raise AssertionError(f"{cfg.name}: cache at {cache.cur_pos}")
    out = {"batch": batch, "prompt": prompt, "frames": frames,
           "prefix": cfg.num_prefix_tokens, "layers": cfg.n_layers,
           "flash_launches": counts["flash"],
           "flash_by_causal": {str(k): v for k, v in by_causal.items()},
           "ttft_ms": ttft * 1e3, "decode_steps": steps,
           "decode_step_ms_mean": sum(secs) / max(len(secs), 1) * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"{cfg.name} ({cfg.n_layers} layers"
        f"{f' + {sum(s.n for s in cfg.enc_segments)} encoder' if cfg.enc_segments else ''}"
        f") batch {batch}: {frames or cfg.num_prefix_tokens or 0} "
        f"{'frames' if frames else 'prefix'} + {prompt} tokens; prefill "
        f"{out['ttft_ms']:.1f} ms, flash launches {counts['flash']} "
        f"(causal {by_causal[True]}, non-causal {by_causal[False]}); "
        f"{steps} decode steps, {out['decode_step_ms_mean']:.3f} ms mean; "
        f"peak memory {out['peak_bytes'] / 2**30:.2f} GiB; logits finite")
    return params, out


def families_train(dev):
    """Phase 16: one training step at full width, 2 layers, 1 x T1_SEQ
    tokens, card against CPU (``train_card_vs_cpu``), for the MoE
    dispatch's backward and the scan's; no kernel may launch."""
    import torch
    from repro_torch import configs
    out = {}
    for arch in T16_ARCHS:
        cfg = cut(configs.get_config(arch), 2)
        zero_counts()
        side, match, restore = follow_cpu_routes(cfg)
        try:
            rec = train_card_vs_cpu(cfg, dev, T1_SEQ, side)
        finally:
            restore()
            if match is not None:
                routes = match.record(f"train {arch} (forward and remat "
                                      f"recompute)")
        counts = read_counts()
        if counts["flash"] or counts["conv"] or counts["mvm"]:
            raise AssertionError(f"train {arch}: the training path launched a "
                                 f"kernel: {counts}")
        if match is not None:
            rec.update(routes)
        out[arch] = rec
        log(f"train {arch} 2 layers: card vs cpu within {rec['loss_rel']:.2e} "
            f"(loss), {rec['grad_norm_rel']:.2e} (grad norm), "
            f"{rec['worst_grad_rel']:.2e} (worst leaf gradient); no kernel "
            f"launched")
        torch.cuda.empty_cache()
    return out


def other_families(dev, detail, sync):
    """Phases 13-16.  Returns the main path's flash launches and its flash
    timings for the ``kernels`` line."""
    import torch
    from repro_torch.configs import get_config
    detail["families_card_vs_cpu"] = families_card_vs_cpu(dev)

    # ---- 14. the main path: granite-moe-3b-a800m through Server ------------
    granite = get_config(MAIN_ARCH)
    server, detail["granite_serve"] = serve_counted(
        granite, dev, SERVE_REQUESTS, SERVE_LENS, SERVE_MAX_NEW,
        SERVE_MAX_BATCH, granite.n_layers, sync)
    main_launches = detail["granite_serve"]["flash_launches"]
    detail["granite_profile"] = profile_serving(granite, server.params, dev,
                                                PATH_B, PATH_S)
    detail["granite_flash"] = flash_timings(dev, granite)
    del server
    torch.cuda.empty_cache()

    # ---- 15. the other families at full width ------------------------------
    for arch, n, lens, max_new, per_prefill in FAMILY_SERVE:
        cfg = get_config(arch)
        server, rec = serve_counted(cfg, dev, n, lens, max_new, SERVE_MAX_BATCH,
                                    per_prefill, sync)
        detail[f"serve_{arch}"] = rec
        detail[f"profile_{arch}"] = profile_serving(cfg, server.params, dev,
                                                    PATH_B, lens[1])
        if per_prefill:
            detail[f"flash_{arch}"] = flash_timings(dev, cfg, PATH_B, lens[1])
        del server
        torch.cuda.empty_cache()
    for arch, batch, prompt, steps, frames, layers, per_prefill in FAMILY_STEPS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cut(cfg, layers)
        params, detail[f"steps_{arch}"] = step_path(
            cfg, dev, batch, prompt, steps, frames, per_prefill, sync)
        del params
        torch.cuda.empty_cache()

    # ---- 16. training, card against CPU ------------------------------------
    detail["families_train"] = families_train(dev)
    return main_launches, detail["granite_flash"]


# ---------------------------------------------------------------------------
# Launch and sharding, and the benchmark harness (phases 17-20)
# ---------------------------------------------------------------------------

SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS = 4, 2048, 32
DRYRUN_ARCHS = ("gemma3-1b", "granite-moe-3b-a800m")
DRYRUN_TIMEOUT_S = 900
DRYRUN_REFERENCE = ROOT / "tests" / "data" / "dryrun_reference_pod16x16.json"
CARD_EXAMPLES = ("serve_lm.py", "schedule_and_run_cnn.py")
BENCH_SUITES = ("fig2", "fig3", "table1", "fig4", "yolo", "kernels")


def start_dryruns():
    """Phase 18's dry runs, started before phase 1 so that they run on the
    host's cores while the card phases run: one subprocess per arch, each
    on a fake process group with no card visible (the fake group never
    shares a process with the card's), one thread, at the lowest CPU
    priority (the card phases' host-bound timings keep the cores they
    need).  Returns {arch: (process, log)}."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    OUT_DIR.mkdir(exist_ok=True)
    procs = {}
    for arch in DRYRUN_ARCHS:
        out = open(OUT_DIR / f"dryrun_{arch}.log", "w")
        procs[arch] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--force"], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19)), out)
    return procs


def stop(procs) -> None:
    """End every process of ``start_dryruns`` that still runs."""
    for proc, out in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        out.close()


def phase14_prompts(cfg, n, width):
    """The first ``n`` prompts of phase 14 (``lm_serve``'s seeded lengths
    and tokens), left-padded with token 0 to ``width`` as ``Server`` pads a
    batch: (n, width) int64."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    sizes = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1, SERVE_REQUESTS)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, int(k)))
               for k in sizes]
    return torch.stack([F.pad(p, (width - p.shape[0], 0))
                        for p in prompts[:n]])


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_serving(dev, sync):
    """Phase 17: granite-moe-3b-a800m at full width and depth (phase 14's
    weights, seed 0, and its first 4 prompts, left-padded to 2,048) through
    ``make_prefill_step``/``make_decode_step``, first unsharded, then on a
    real one-rank NCCL process group: ``make_host_mesh()``, parameters,
    batch and cache placed by ``sharding`` as DTensors, the steps under
    ``activation_mesh``.  One warm-up prefill, then with the counts set to
    0 the prefill (32 tensor-core flash launches, through ``local_map``)
    and 32 greedy decode steps, each fed the sharded run's own token; the
    tokens must equal the unsharded run's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import model, sharding, transformer
    from repro_torch.tree import tree_leaves
    cfg = get_config(MAIN_ARCH)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = phase14_prompts(cfg, SHARD_BATCH, SHARD_PROMPT).to(dev)
    prefill = model.make_prefill_step(cfg, SHARD_PROMPT + SHARD_STEPS)
    decode = model.make_decode_step(cfg)

    logits, cache = prefill(params, {"tokens": toks})
    want_logits, want_toks = [logits], []
    for _ in range(SHARD_STEPS):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        want_toks.append(tok)
        logits, cache = decode(params, tok, cache)
        want_logits.append(logits)
    del cache
    torch.cuda.empty_cache()

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        dparams = sharding.distribute(params, sharding.param_shardings(
            cfg, mesh, params))
        batch = {"tokens": toks}
        dbatch = sharding.distribute(batch, sharding.batch_shardings(mesh,
                                                                     batch))
        with sharding.activation_mesh(mesh):
            prefill(dparams, dbatch)                    # warm-up
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            t = time.perf_counter()
            logits, cache = prefill(dparams, dbatch)
            sync()
            prefill_s = time.perf_counter() - t
            counts = read_counts()
            cache = sharding.distribute(cache, sharding.cache_shardings(mesh,
                                                                        cache))
            leaves = [x for x in tree_leaves((dparams, cache.entries, logits))]
            if not all(isinstance(x, DTensor)
                       and x.to_local().device.type == dev.type
                       for x in leaves):
                raise AssertionError("sharded serving: a leaf is not a DTensor "
                                     "on the card")
            got_toks, secs, d_max = [], [], 0.0
            for i in range(SHARD_STEPS):
                full = logits.full_tensor()
                d_max = max(d_max, (full - want_logits[i]).abs().max().item())
                tok = torch.argmax(logits[:, -1:], dim=-1)
                got_toks.append(tok.full_tensor())
                t = time.perf_counter()
                logits, cache = decode(dparams, tok, cache)
                sync()
                secs.append(time.perf_counter() - t)
            full = logits.full_tensor()
            d_max = max(d_max, (full - want_logits[-1]).abs().max().item())
            peak = torch.cuda.max_memory_allocated(dev)
    finally:
        dist.destroy_process_group()
    check_flash_counts(counts, cfg.n_layers, 1, f"sharded {cfg.name}")
    if not torch.isfinite(full).all() or full.shape != (SHARD_BATCH, 1,
                                                        cfg.vocab):
        raise AssertionError(f"sharded {cfg.name}: bad logits "
                             f"{tuple(full.shape)}")
    same = torch.equal(torch.cat(got_toks, 1), torch.cat(want_toks, 1))
    rec = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": "nccl", "batch": SHARD_BATCH, "prompt": SHARD_PROMPT,
           "decode_steps": SHARD_STEPS, "flash_launches": counts["flash"],
           "flash_instances": counts["flash_instances"],
           "max_abs_logit_d": d_max,
           "max_abs_logit": max(x.abs().max().item() for x in want_logits),
           "tokens_equal": same, "prefill_ms": prefill_s * 1e3,
           "decode_step_ms_mean": sum(secs) / len(secs) * 1e3,
           "decode_step_ms_max": max(secs) * 1e3, "peak_bytes": peak}
    log(f"sharded {cfg.name} ({cfg.n_layers} layers) on a one-rank NCCL mesh "
        f"{rec['mesh']}: prefill of ({SHARD_BATCH}, {SHARD_PROMPT}) "
        f"{rec['prefill_ms']:.1f} ms, flash launches {counts['flash']} (by "
        f"instance {counts['flash_instances']}); {SHARD_STEPS} decode steps, "
        f"{rec['decode_step_ms_mean']:.3f} ms mean, "
        f"{rec['decode_step_ms_max']:.3f} ms max; peak memory "
        f"{peak / 2**30:.2f} GiB; max |logit d| against the unsharded steps "
        f"{d_max:.3e} (max |logit| {rec['max_abs_logit']:.3f}); tokens equal "
        f"{same}")
    if not same:
        raise AssertionError(f"sharded {cfg.name}: greedy tokens differ from "
                             f"the unsharded steps'")
    return rec


def dryrun_cells(procs):
    """Phase 18: wait for the dry runs of ``start_dryruns``, then print each
    cell's status, per-device peak, FLOPs and collective bytes, and the
    roofline's row for it.  Every supported shape must end ``ok``."""
    from repro_torch.configs import SHAPES, get_config, shape_supported
    from repro_torch.launch import dryrun, roofline
    deadline = time.perf_counter() + DRYRUN_TIMEOUT_S
    for arch, (proc, out) in procs.items():
        rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        out.close()
        if rc != 0:
            raise AssertionError(f"dry run {arch}: exit {rc} (log in "
                                 f"chiprun_out/dryrun_{arch}.log)")
    log("dry run on the fake 16x16 mesh (256 ranks, CPU; model estimates "
        "under H100 constants, not measurements), each figure beside the "
        "reference's dry run of the cell [ref] and port / ref:")
    refs = json.loads(DRYRUN_REFERENCE.read_text())["cells"]
    cells = {}
    for arch in DRYRUN_ARCHS:
        for shape in SHAPES:
            with open(dryrun.cell_path(arch, shape, "pod16x16")) as f:
                art = json.load(f)
            want = "ok" if shape_supported(get_config(arch), SHAPES[shape])[0] \
                else "skipped"
            if art["status"] != want:
                raise AssertionError(f"dry run {arch} x {shape}: "
                                     f"{art['status']}, want {want}: "
                                     f"{art.get('error', '')[:300]}")
            cells[f"{arch}__{shape}"] = art
            if want == "skipped":
                log(f"  {arch} x {shape}: skipped ({art['reason'][:60]})")
                continue
            row = roofline.analyse(art)
            cost = art["cost"]
            coll = cost["collective_bytes_per_device"]
            ref = refs[f"{arch}__{shape}"]
            vs = dryrun.against_reference(art, ref)
            log(f"  {arch} x {shape}: ok, step {art['step_seconds']:.1f} s on "
                f"the host; per device peak "
                f"{art['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB "
                f"[{ref['memory']['peak_estimate_bytes'] / 2**30:.2f}] "
                f"{vs['peak']:.2f}x (against the reference less its f32 "
                f"copies: {vs['peak_held']:.2f}x), "
                f"{cost['flops_per_device']:.4e} FLOP "
                f"[{ref['cost']['flops_per_device']:.4e}] {vs['flops']:.2f}x "
                f"(matrix products {vs['matmul_flops']:.2f}x), collectives "
                "MiB port [reference; with its tuple collectives] "
                + (", ".join(f"{k} {g / 2**20:.1f} [{w / 2**20:.1f}; "
                             f"{t / 2**20:.1f}] "
                             + (f"{g / w:.2f}x" if w else "-")
                             for k, (g, w, t) in vs["collectives"].items())
                   or "none"))
            art["against_reference"] = vs
            log(f"    roofline (estimate): compute {row.compute_s:.3e} s, "
                f"memory(ops) {row.memory_s:.3e} s, memory(fused) "
                f"{row.memory_fused_s:.3e} s, collective {row.collective_s:.3e}"
                f" s; {row.dominant}-bound, useful {row.useful_ratio:.2f}, "
                f"roofline {row.roofline_fraction:.2f}")
            cells[f"{arch}__{shape}"]["roofline"] = row.__dict__
    return cells


def examples_on_card():
    """Phase 19: ``examples/torch/serve_lm.py`` and
    ``schedule_and_run_cnn.py`` on the card (their default device) as
    subprocesses; each must exit 0 and report kernel launches."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for name in CARD_EXAMPLES:
        t = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "examples" / "torch" /
                                                  name)],
                             cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t
        for line in res.stdout.splitlines():
            log(f"  {name}: {line}")
        if res.returncode != 0:
            raise AssertionError(f"example {name}: exit {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        launches = [int(x) for x in re.findall(
            r"(?:flash kernel launches|conv) (\d+)", res.stdout)]
        if not launches or min(launches) == 0:
            raise AssertionError(f"example {name}: no kernel launch reported")
        out[name] = {"wall_s": wall, "stdout": res.stdout}
        log(f"example {name}: exit 0 in {wall:.1f} s (process start and "
            f"kernel load included)")
    return out


#: the reference's kernel-bench cases (``benchmarks/kernel_bench.py``)
BENCH_CASES = ("imc_mvm.256x512x512", "imc_mvm.1024x1024x1024",
               "imc_mvm.128x4096x4096", "flash.2x8x1024x128",
               "flash.1x8x4096x128")


def check_kernel_bench(kb):
    """The kernel bench's record must hold every reference case, each run
    on the card (a kernel time), launched (a nonzero count) and equal to
    its plain version."""
    if tuple(kb) != BENCH_CASES:
        raise AssertionError(f"kernel bench: cases {list(kb)}, want "
                             f"{list(BENCH_CASES)}")
    for name, rec in kb.items():
        if "kernel_us" not in rec or not rec.get("matches_plain") \
                or rec.get("launches", 0) < 1:
            raise AssertionError(f"kernel bench {name}: {rec}")
    return kb


def bench_on_card(card):
    """Phase 20: the port's benchmark harness as a user runs it, in a
    subprocess: the paper's suites on the host and the kernel bench on the
    card.  It must exit 0, and every kernel-bench case must have launched
    its kernel and equal its plain version."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "benchmarks_torch.run", *BENCH_SUITES]
    t = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    wall = time.perf_counter() - t
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "bench_torch.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"benchmarks_torch.run: exit {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        if line.startswith("CSV,") or "paper" in line:
            log(f"  {line}")
    art = ROOT / "artifacts" / "bench_torch"
    kb = check_kernel_bench(json.loads((art / "kernel_bench.json")
                                       .read_text()))
    log(f"kernel bench on {card} (CUDA events, launches back to back, "
        f"warm; µs):")
    log("  case                     kernel      plain    library      bound"
        "  bound by            launches  max |d|")
    for name, rec in kb.items():
        log(f"  {name:<22s} {rec['kernel_us']:10.2f} {rec['plain_us']:10.2f} "
            f"{rec['library_us']:10.2f} {rec['bound_us']:10.2f}  "
            f"{rec['bound']} ({rec['bound_constant']}){'':<3s} "
            f"{rec['launches']:8d}  {rec['max_abs_err']:.2e}  "
            f"[{rec['library']}]")
    suites = {n: json.loads((art / f"{f}.json").read_text()) for n, f in
              (("fig2", "fig2_resnet8"), ("fig3", "fig3_resnet18"),
               ("table1", "table1_utilization"), ("fig4", "fig4_imc_dpu"),
               ("yolo", "yolo_latency"))}
    log(f"benchmarks_torch.run {' '.join(BENCH_SUITES)}: exit 0 in "
        f"{wall:.1f} s (process start and kernel load included)")
    return {"wall_s": wall, "kernel_bench": kb, "suites": suites}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    dryruns = start_dryruns()
    try:
        return run_phases(dryruns)
    finally:
        stop(dryruns)


def run_phases(dryruns) -> int:
    import torch
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
    flash_log = Path(f"{libs['flash_attention']}.log")
    tc_ptxas = {fn: r for fn, r in ptxas_report(flash_log.read_text()).items()
                if "flash_tc_kernel" in fn}
    if not tc_ptxas:
        raise AssertionError("ptxas reported no flash tensor-core instance")
    detail["flash_tc_ptxas"] = tc_ptxas
    for fn, r in sorted(tc_ptxas.items()):
        log(f"ptxas flash tensor-core instance {fn}: {r.get('registers')} "
            f"registers, {r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
    # the serving path's instance: hd 288, staged by cp.async
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    path_tag = f"ILi{fa.tc_steps(get_config('gemma3-1b').hd)}ELb1E"
    path_inst = [r for fn, r in tc_ptxas.items() if path_tag in fn]
    if len(path_inst) != 1 or path_inst[0].get("spill_stores") != 0 \
            or path_inst[0].get("spill_loads") != 0:
        raise AssertionError(f"ptxas: the serving path's flash instance "
                             f"{path_tag} spills or is missing: {path_inst}")
    # the other families' path instances, cp.async-staged like the one
    # above: hd 64 (4 steps) and hd 256 (16 steps)
    for steps in (4, 16):
        tag = f"ILi{steps}ELb1E"
        inst = [r for fn, r in tc_ptxas.items() if tag in fn]
        if len(inst) != 1 or inst[0].get("spill_stores") != 0 \
                or inst[0].get("spill_loads") != 0:
            raise AssertionError(f"ptxas: the other families' flash instance "
                                 f"{tag} spills or is missing: {inst}")
    log("ptxas: the 4-step and 16-step cp.async flash instances (the other "
        "families' paths) do not spill")
    g18 = graphs.resnet18_graph()
    path_convs = conv_shapes(g18, BATCH)
    path_instances = {f"imc_conv2d/{conv2d.conv_instance(c[3], c[4], True)}"
                      for c in path_convs}
    path_instances.add(f"imc_mvm/{mvm_mod.mvm_instance(256, True)}")
    detail["int8_ptxas"] = int8_ptxas(libs, path_instances)

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand_int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def rand_scales(n):
        return torch.rand((n,), generator=gen, device=dev) * 0.1 + 1e-3

    # ---- 2. kernels against their plain versions -------------------------
    int8_rule_checks()
    distinct = sorted(set(path_convs), key=path_convs.index)
    ragged_convs = [(2, 12, 12, 8, 130, 5, 1, "SAME"),
                    (2, 9, 9, 3, 6, 3, 2, "SAME"),
                    (2, 10, 10, 5, 7, 1, 1, "SAME"),
                    (3, 11, 13, 3, 130, 3, 2, "SAME"),
                    (2, 9, 9, 4, 6, 3, 2, "VALID"),
                    # Cin 16 and 48 (16-byte pieces, not 32), Cin 24 (only
                    # a multiple of 8: gathered), Cout 130 on cp.async
                    (4, 10, 10, 16, 40, 3, 1, "SAME"),
                    (4, 10, 10, 48, 96, 3, 2, "SAME"),
                    (4, 10, 10, 24, 64, 3, 1, "SAME"),
                    (4, 8, 8, 64, 130, 3, 1, "SAME")]
    err = {"imc_conv2d": 0.0, "imc_mvm": 0.0}
    conv_inputs = {}
    for shape in distinct + ragged_convs:
        B, H, W, cin, cout, k, s, padding = shape
        qx, qw = rand_int8((B, H, W, cin)), rand_int8((k, k, cin, cout))
        sw, bias = rand_scales(cout), torch.randn((cout,), generator=gen,
                                                  device=dev)
        sx = torch.full((), 0.04, device=dev)
        pads = layers.conv_pads(H, W, k, s, padding)
        inst = conv_check(qx, qw, sx, sw, bias, s, pads, str(shape), err)
        conv_inputs[shape] = (qx, qw, sx, sw, bias, pads, inst)
    # x one byte off 16-byte alignment at a stage-1 shape: the gather
    # staging at path width
    B, H, W, cin, cout, k, s, padding = distinct[1]
    buf = rand_int8((B * H * W * cin + 1,))
    qx = buf[1:].view(B, H, W, cin)
    qw = rand_int8((k, k, cin, cout))
    conv_check(qx, qw, torch.full((), 0.04, device=dev), rand_scales(cout),
               torch.randn((cout,), generator=gen, device=dev), s,
               layers.conv_pads(H, W, k, s, padding),
               f"{distinct[1]} x at 16-byte offset 1", err)
    # all-+-127 operands at stage 4's K = 2,304: |acc| = 127^2 * 2304 at
    # interior pixels, exact in int32 and in the kernel
    qx = torch.full((BATCH, 4, 4, 256), 127, dtype=torch.int8, device=dev)
    qw = torch.full((3, 3, 256, 256), 127, dtype=torch.int8, device=dev)
    qw[..., 1::2] = -127
    acc = ref.conv2d_acc(qx, qw, 1, (1, 1, 1, 1))
    if acc.abs().max().item() != 127 * 127 * 2304:
        raise AssertionError("extreme conv: the interior sum is not 127^2 * 2304")
    conv_check(qx, qw, torch.full((), 1e-6, device=dev), rand_scales(256),
               torch.randn((256,), generator=gen, device=dev), 1, (1, 1, 1, 1),
               f"({BATCH},4,4,256->256) all +-127, |acc| max "
               f"{acc.abs().max().item()}", err)
    log(f"check imc_conv2d: torch.equal at {len(distinct)} path shapes "
        f"(batch {BATCH}), {len(ragged_convs)} ragged shapes, an unaligned x "
        f"and all-+-127 operands")

    fc_shape = (BATCH, 256, 10)
    mvm_inputs = {}
    for M, K, N in [fc_shape, (257, 129, 65), (1, 512, 512)]:
        qx, qw = rand_int8((M, K)), rand_int8((K, N))
        sw, bias = rand_scales(N), torch.randn((N,), generator=gen, device=dev)
        sx = torch.full((), 0.02, device=dev)
        before = dict(imc_mvm.launches_by_instance)
        got = imc_mvm(qx, qw, sx, sw, bias)
        want = ref.imc_mvm_ref(qx, qw, sx, sw, bias)
        torch.cuda.synchronize()
        ran = [n for n, c in imc_mvm.launches_by_instance.items()
               if c != before[n]]
        rule = mvm_mod.mvm_instance(K, qx.data_ptr() % 16 == 0)
        if ran != [rule]:
            raise AssertionError(f"imc_mvm {(M, K, N)}: ran {ran}, the rule "
                                 f"names {rule}")
        if not torch.equal(got, want):
            raise AssertionError(f"imc_mvm != plain at {(M, K, N)}: max |d| "
                                 f"{(got - want).abs().max().item()}")
        err["imc_mvm"] = max(err["imc_mvm"], (got - want).abs().max().item())
        mvm_inputs[(M, K, N)] = (qx, qw, sx, sw, bias)
        log(f"check imc_mvm {(M, K, N)} [{rule}]: torch.equal")

    grad_guard_checks(dev)

    # ---- 3. placement: schedule and simulate the graph phase 4 executes ----
    lblp, detail["placement"] = schedule_and_simulate(g18)
    if set(lblp.mapping) != set(g18.nodes):
        raise AssertionError("place: the LBLP mapping does not cover the graph")
    detail["placement"]["yolov8n"] = place_yolov8n()
    detail["elastic"] = elastic_sessions()
    detail["serving"] = serving_plane()
    detail["partition"] = stage_partition()

    # ---- 4. main path ------------------------------------------------------
    def serve(cfg, g, n_requests, label):
        params = resnet.init(torch.Generator().manual_seed(0), cfg, device=dev)
        data = torch.Generator(device=dev).manual_seed(1)
        x_cal = torch.randn((BATCH, 32, 32, 3), generator=data, device=dev)
        scales = quant.calibrate_resnet(params, x_cal, cfg)
        xs = torch.randn((n_requests, BATCH, 32, 32, 3), generator=data,
                         device=dev)
        executor.execute(g, params, x_cal, mode="int8", act_scales=scales)
        torch.cuda.synchronize()
        zero_counts()
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
        by_inst = dict(imc_conv2d.launches_by_instance)
        want_inst = dict.fromkeys(by_inst, 0)
        for c in conv_shapes(g, BATCH):
            want_inst[conv2d.conv_instance(c[3], c[4], True)] += n_requests
        if by_inst != want_inst:
            raise AssertionError(f"{label}: conv launches by instance {by_inst}"
                                 f", the rule names {want_inst}")
        staging = {st: sum(v for k, v in by_inst.items() if k.startswith(st))
                   for st in ("cp_async", "gather")}
        log(f"{label}: {n_requests} requests x {BATCH} frames; launches "
            f"conv {counts[0]} mvm {counts[1]} ({n_conv} + {n_mvm} per request)"
            f"; conv by instance {by_inst} (cp.async {staging['cp_async']}, "
            f"gather {staging['gather']}); mvm by instance "
            f"{imc_mvm.launches_by_instance}")
        for y in outs:
            if y.shape != (BATCH, cfg["num_classes"]) or not torch.isfinite(y).all():
                raise AssertionError(f"{label}: bad logits {tuple(y.shape)}")
        # the plain path: the same executor on CPU copies
        y_cpu = executor.execute(g, to_device(params, "cpu"), xs[0].cpu(),
                                 mode="int8", act_scales=scales)
        y_dev = outs[0].cpu()
        dmax = (y_dev - y_cpu).abs().max().item()
        lmax = y_cpu.abs().max().item()
        top1 = bool(torch.equal(y_dev.argmax(-1), y_cpu.argmax(-1)))
        log(f"{label}: card vs cpu plain path: max |d| {dmax:.3e}, "
            f"max |logit| {lmax:.4f}, top-1 identical {top1}")
        if not top1 or dmax > LOGIT_RTOL * lmax:
            raise AssertionError(f"{label}: logits disagree with the plain path")
        return params, scales, xs, lat, total, counts

    zero_counts()
    log(f"resnet18_cifar: executing the graph LBLP placed ({len(g18)} nodes on "
        f"{len(set(lblp.mapping.values()))} PUs of the IMCE model)")
    params, scales, xs, lat, total, counts18 = serve(
        resnet.RESNET18_CIFAR, g18, REQUESTS, "resnet18_cifar")
    cp_async = sum(v for k, v in imc_conv2d.launches_by_instance.items()
                   if k.startswith("cp_async"))
    if (cp_async, counts18[0] - cp_async) != (19 * REQUESTS, REQUESTS):
        raise AssertionError(f"resnet18_cifar: {cp_async} cp.async conv "
                             f"launches of {counts18[0]}; want 19 and 1 a "
                             f"request")
    fps = REQUESTS * BATCH / total
    detail["e2e"] = {"frames_per_s": fps, "requests": REQUESTS, "batch": BATCH,
                     "latency_ms": [t * 1e3 for t in lat]}
    log(f"resnet18_cifar int8: {fps:.1f} frames/s, request latency mean "
        f"{sum(lat) / len(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms")
    zero_counts()
    serve(resnet.RESNET8, graphs.resnet8_graph(), 1, "resnet8")

    # device busy share over one request
    wall, busy, top = profile_kernels(lambda: executor.execute(
        g18, params, xs[0], mode="int8", act_scales=scales))
    detail["profile"] = {"wall_ms": wall, "device_busy_ms": busy, "top": top}
    log(f"profile of one request: wall {wall:.3f} ms (under the profiler), "
        f"kernels {busy:.3f} ms")
    for row in top[:8]:
        log(f"  {row['ms']:9.3f} ms  x{row['calls']:<4d} {row['name'][:70]}")

    # ---- 5. kernel timings at the path's shapes ----------------------------
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
                int(qx.data_ptr() % 16 == 0))

        def launch(st, keep=(wp, out)):   # keep: the buffers outlive it
            _build.check(conv_fn(*args, st), "imc_conv2d")
        return launch

    conv_rows = []
    tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "wrapper_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    for shape in distinct:
        B, H, W, cin, cout, k, s, padding = shape
        qx, qw, sx, sw, bias, pads, inst = conv_inputs[shape]
        n = path_convs.count(shape)
        ho, wo = layers.conv_out_hw(H, W, k, s, padding)
        launch = conv_launcher(qx, qw, sx, sw, bias, s, pads)
        ms = cuda_time_ms(lambda: launch(stream), 20)
        graph_ms = graph_time_ms(launch)
        wrapper_ms = cuda_time_ms(lambda: imc_conv2d(
            qx, qw, sx, sw, bias, stride=s, pads=pads), 20)
        plain_ms = cuda_time_ms(lambda: ref.conv2d_ref(
            qx, qw, sx, sw, bias, stride=s, pads=pads), 5, warmup=1)
        n_bytes = (B * H * W * cin + k * k * cin * cout + 4 + 8 * cout
                   + 4 * B * ho * wo * cout)
        n_ops = 2 * B * ho * wo * k * k * cin * cout
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        conv_rows.append({"shape": list(shape), "instance": inst,
                          "per_request": n, "ms": ms, "graph_ms": graph_ms,
                          "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bytes": n_bytes, "ops": n_ops})
        tot["ms"] += n * ms
        tot["graph_ms"] += n * graph_ms
        tot["wrapper_ms"] += n * wrapper_ms
        tot["plain_ms"] += n * plain_ms
        tot["bound_ms"] += n * b_ms
        tot["bytes_ms"] += n * n_bytes / HBM_BYTES_PER_S * 1e3
        tot["ops_ms"] += n * n_ops / INT8_OPS_PER_S * 1e3
        log(f"  conv {shape} x{n} [{inst}]: kernel {ms:.4f} ms (graph "
            f"{graph_ms:.4f} ms, {n_ops / graph_ms / 1e9:.0f} TOP/s, "
            f"{n_bytes / graph_ms / 1e6:.0f} GB/s), wrapper {wrapper_ms:.4f}"
            f" ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    detail["imc_conv2d"] = conv_rows

    M, K, N = fc_shape
    qx, qw, sx, sw, bias = mvm_inputs[fc_shape]
    out = torch.empty((M, N), device=dev)
    mvm_args = (qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                bias.data_ptr(), out.data_ptr(), M, K, N)

    def mvm_launch(st):
        _build.check(mvm_fn(*mvm_args, st), "imc_mvm")

    mvm_ms = cuda_time_ms(lambda: mvm_launch(stream), 50)
    mvm_graph_ms = graph_time_ms(mvm_launch)
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
                         "graph_ms": mvm_graph_ms,
                         "wrapper_ms": mvm_wrapper_ms, "plain_ms": mvm_plain_ms,
                         "bound_ms": mvm_bound, "bound_by": mvm_by,
                         "library_ms": mvm_library_ms}
    log(f"  mvm {fc_shape} x1: kernel {mvm_ms:.4f} ms (graph "
        f"{mvm_graph_ms:.4f} ms), wrapper "
        f"{mvm_wrapper_ms:.4f} ms, plain {mvm_plain_ms:.4f} ms, bound "
        f"{mvm_bound:.6f} ms ({mvm_by}), library {mvm_library_ms}")
    log(f"per request: imc_conv2d kernels {tot['ms']:.4f} ms (graph "
        f"{tot['graph_ms']:.4f} ms, wrappers "
        f"{tot['wrapper_ms']:.4f} ms), plain {tot['plain_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms (bytes {tot['bytes_ms']:.4f} ms, ops "
        f"{tot['ops_ms']:.4f} ms)")
    detail["imc_conv2d_per_request"] = tot

    # ---- 5b. YOLOv8n at 640x640 in float on the card ------------------------
    log(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    yolo_params, detail["yolov8n_card_vs_cpu"] = yolo_card_vs_cpu(
        dev, YOLO_HW, YOLO_CHECK_FRAMES)
    detail["yolov8n_serve"] = yolo_serve(yolo_params, dev, YOLO_HW,
                                         YOLO_REQUESTS, YOLO_BATCH,
                                         torch.cuda.synchronize)
    from repro_torch.models.cnn import yolo
    x_yolo = torch.randn((YOLO_BATCH, YOLO_HW, YOLO_HW, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    wall, busy, top = profile_kernels(lambda: yolo.forward(yolo_params, x_yolo))
    detail["yolov8n_profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                                 "top": top}
    yb = detail["yolov8n_serve"]
    log(f"profile of one yolov8n request ({YOLO_BATCH} frames): wall "
        f"{wall:.3f} ms (under the profiler), kernels {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% busy); bound {yb['bound_ms']:.4f} ms, "
        f"measured request latency mean {yb['latency_ms_mean']:.3f} ms")
    for row in top[:8]:
        log(f"  {row['ms']:9.3f} ms  x{row['calls']:<4d} {row['name'][:70]}")
    del yolo_params, x_yolo
    torch.cuda.empty_cache()

    # ---- 6. flash attention against its plain version --------------------
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import transformer
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    gemma = get_config("gemma3-1b")
    local_window = min(gemma.segments[0].window_pattern)
    flash_err = flash_checks(dev, gemma.hd, local_window)

    # ---- 7. full width, cut depth: card against the CPU plain path ---------
    period = cut(gemma, len(gemma.segments[0].window_pattern))
    detail["lm_card_vs_cpu"] = lm_card_vs_cpu(period, dev, LM_PROMPT,
                                              LM_DECODE_STEPS)
    log(f"gemma3-1b {period.n_layers} layers, full width: card vs cpu within "
        f"{detail['lm_card_vs_cpu']['worst_rel']:.3e} of max |logit| (limit "
        f"{LM_LOGIT_TOL}), {detail['lm_card_vs_cpu']['tokens_compared']} "
        f"tokens compared; cpu prefill "
        f"{detail['lm_card_vs_cpu']['cpu_prefill_s']:.1f} s")

    # ---- 8. the LM main path: 26-layer gemma3-1b through Server ------------
    server, detail["serve"] = serve_counted(
        gemma, dev, SERVE_REQUESTS, SERVE_LENS, SERVE_MAX_NEW, SERVE_MAX_BATCH,
        gemma.n_layers, torch.cuda.synchronize)

    # ---- 9. flash timings and the LM profile -------------------------------
    detail["flash_attention"] = flash_timings(dev, gemma)
    prof = profile_serving(gemma, server.params, dev, PATH_B, PATH_S)
    detail["profile_prefill"], detail["profile_decode"] = prof["prefill"], \
        prof["decode"]

    # ---- 10-12. LM training (T1-T3): no kernel on this path ---------------
    import dataclasses
    import tempfile
    from repro_torch.configs import GLOBAL_WINDOW, SHAPES, Segment, ShapeSpec
    from repro_torch.optim import adamw
    del server
    torch.cuda.empty_cache()
    two = dataclasses.replace(gemma, segments=(
        Segment("attn", 2, window_pattern=(local_window, GLOBAL_WINDOW)),))
    detail["train_t1"] = train_card_vs_cpu(two, dev, T1_SEQ)
    log(f"train T1: card vs cpu within {detail['train_t1']['loss_rel']:.2e} "
        f"(loss), {detail['train_t1']['grad_norm_rel']:.2e} (grad norm), "
        f"{detail['train_t1']['worst_grad_rel']:.2e} (worst leaf gradient)")

    t2_shape = ShapeSpec("train_4k_cut", SHAPES["train_4k"].seq_len, T2_BATCH,
                         "train")
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t2, t2_step = train_steps(gemma, dev, t2_shape, T2_MICROBATCH, T2_STEPS,
                              adamw.AdamWConfig(warmup_steps=1),
                              torch.cuda.synchronize)
    if flash_attention.launches or imc_conv2d.launches or imc_mvm.launches:
        raise AssertionError("train T2: the training path launched a kernel")
    timed = t2["step_s"][1:]
    n_params = transformer.param_count(gemma)
    tokens = t2_shape.global_batch * t2_shape.seq_len
    step_s = sum(timed) / len(timed)
    t2.update(params=n_params, tokens=tokens, step_s_mean=step_s,
              tok_per_s=tokens / step_s,
              flop=6 * n_params * tokens,
              bound_s=6 * n_params * tokens / BF16_FLOPS_PER_S,
              peak_bytes=torch.cuda.max_memory_allocated(dev))
    t2["mfu"] = t2["bound_s"] / step_s
    detail["train_t2"] = t2
    log(f"train T2 {gemma.name} {gemma.n_layers} layers ({n_params} params), "
        f"batch {T2_BATCH} x {t2_shape.seq_len} in {T2_BATCH // T2_MICROBATCH} "
        f"microbatches of {T2_MICROBATCH}: losses "
        f"{', '.join(f'{x:.4f}' for x in t2['losses'])}; warm step "
        f"{t2['step_s'][0]:.3f} s, timed {', '.join(f'{x:.3f}' for x in timed)} s"
        f" (mean {step_s:.3f} s), {t2['tok_per_s']:.1f} tok/s; bound 6 N tokens "
        f"= {t2['flop']:.3e} FLOP at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s = "
        f"{t2['bound_s']:.4f} s, MFU {100 * t2['mfu']:.1f}%; peak memory "
        f"{t2['peak_bytes'] / 2**30:.2f} GiB; 0 kernel launches")
    wall, busy, rows = profile_kernels(t2_step, top=None)
    classes = kernel_classes(rows)
    detail["train_t2"]["profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                                     "classes_ms": classes, "top": rows[:16]}
    log(f"profile one T2 step: wall {wall:.1f} ms (under the profiler), "
        f"kernels {busy:.1f} ms ({100 * busy / wall:.1f}%); by class "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items()))
    for row in rows[:12]:
        log(f"  {row['ms']:9.3f} ms  x{row['calls']:<5d} {row['name'][:70]}")
    del t2_step
    torch.cuda.empty_cache()

    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # the example's schedule: lr 3e-4, 30 warmup steps, cosine to the end
        t3 = train_example(stablelm_100m(), dev, T3_STEPS, T3_BATCH, T3_SEQ,
                           T3_CKPT_EVERY, adamw.AdamWConfig(
                               lr=3e-4, warmup_steps=30, total_steps=T3_STEPS),
                           Path(tmp), torch.cuda.synchronize)
    if flash_attention.launches or imc_conv2d.launches or imc_mvm.launches:
        raise AssertionError("train T3: the training path launched a kernel")
    detail["train_t3"] = t3
    # one step of the example's model under the profiler: where its time goes
    t3_cfg = stablelm_100m()
    _, t3_step = train_steps(t3_cfg, dev, ShapeSpec("example", T3_SEQ, T3_BATCH,
                                                    "train"),
                             t3_cfg.microbatch, 2, adamw.AdamWConfig(
                                 lr=3e-4, warmup_steps=1), torch.cuda.synchronize)
    wall, busy, rows = profile_kernels(t3_step, top=None)
    t3["profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                     "launches": sum(r["calls"] for r in rows),
                     "classes_ms": kernel_classes(rows), "top": rows[:8]}
    del t3_step
    log(f"train T3 stablelm-100m ({t3['params']} params), batch {T3_BATCH} x "
        f"{T3_SEQ}, {t3['steps']} steps: loss first10 {t3['first10']:.4f} -> "
        f"last10 {t3['last10']:.4f}; step {1e3 * t3['step_s_median']:.2f} ms "
        f"median ({1e3 * t3['step_s_mean']:.2f} ms mean, checkpoints "
        f"included), run {t3['wall_s']:.1f} s; resumed from "
        f"{t3['resumed_from']}: loss {t3['loss_at_half']:.4f} -> "
        f"{t3['loss_after']:.4f} ({100 * t3['resume_jump']:.2f}%, limit "
        f"{100 * T3_RESUME_RTOL:.0f}%); retries {t3['retries']}, rollbacks "
        f"{t3['rollbacks']}; checkpoint of step {t3['ckpt_step']}: restore "
        f"{t3['restore_s']:.3f} s, save {t3['save_s']:.3f} s")
    pr = t3["profile"]
    log(f"profile one T3 step: wall {pr['wall_ms']:.1f} ms (under the profiler),"
        f" kernels {pr['device_busy_ms']:.1f} ms "
        f"({100 * pr['device_busy_ms'] / pr['wall_ms']:.1f}%) in "
        f"{pr['launches']} launches; by class "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in pr["classes_ms"].items()))

    # ---- 13-16. the other LM families --------------------------------------
    del t3
    torch.cuda.empty_cache()
    main_launches, main_flash = other_families(dev, detail, torch.cuda.synchronize)

    # ---- 17-19. launch and sharding ----------------------------------------
    torch.cuda.empty_cache()
    detail["sharded_serving"] = sharded_serving(dev, torch.cuda.synchronize)
    torch.cuda.empty_cache()
    detail["dryrun"] = dryrun_cells(dryruns)
    detail["examples"] = examples_on_card()

    # ---- 20. the benchmark harness: paper suites, kernel bench on the card -
    torch.cuda.empty_cache()
    detail["bench"] = bench_on_card(card)

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
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": main_launches, "max_abs_err": flash_err,
         "ms": main_flash["ms"], "plain_ms": main_flash["plain_ms"],
         "bound_ms": main_flash["bound_ms"], "bound_by": main_flash["bound_by"],
         "library_ms": main_flash["library_ms"]},
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
