#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure is an uncaught exception and a nonzero exit.
Three kinds of host work run as background jobs from before phase 1 (no
card visible, one thread, nice 19), each joined by its phase: phase 18's
dry runs, phase 21's gloo ranks and phase 20's host suites and perf gate.
A job that exits nonzero, or still runs ``JOB_TIMEOUT_S`` after its
start, fails the run at its join.  The time account logs each phase's
wall seconds when it ends ("phase <id> (<name>): <s> s"), each join's
job wall and the main thread's wait on it ("join <job>: ..."), and the
total ("time account: ..."), and writes them to ``chip_smoke.json``
under ``timing``.

1. the card's name and power limit; build every kernel in
   ``src/repro_torch/csrc`` with nvcc (one process per source, in
   parallel) and print the build time and ptxas resource lines, and the
   registers and spill bytes of each instance of the three flash
   tensor-core kernels (bf16 on wgmma up to hd 128, bf16 on mma.sync at
   hd 129-288, f32) and of each INT8 instance (the serving path's hd-288
   flash instance, granite's wgmma instance, the 16-step instance of the
   other families, the f32 instances at hd 128, the kernel bench's, and
   at 256, its widest, and the ResNet path's INT8 instances must not
   spill; granite's wgmma instance must not have its wgmma serialized,
   and every wgmma instance's SASS, from ``cuobjdump -sass``, must issue
   ``HGMMA``);
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
   through ``executor.GraphedExecute`` (the weights quantized and packed
   once, each request replayed from a CUDA graph captured on the
   calibration batch); the launch counters must read 20 conv and 1 mvm
   launches per request, by instance 19 on the conv's cp.async staging
   and 1 (the stem) on its gather staging; each request's logits must be
   ``torch.equal`` to the plain ``executor.execute(..., mode="int8")`` on
   the card, and request 0's must match the plain path on CPU copies;
   then ResNet-8 once the same way; a ``torch.profiler`` trace of one
   replay must show 20 conv and 1 mvm kernel launches, and one plain
   request is profiled beside it (the graphed and plain latency and
   frames/s and the capture seconds are logged);
5. timings with CUDA events at the path's shapes, by the kernel bench's
   own ``time_case`` over ``kernel_bench.cnn_cases`` (each case held to
   its plain version and its rule's instance; the raw launch back to back
   from the host, L2-cold, replayed from a CUDA graph; the wrapper, the
   plain version, the bound), summed over a request; end-to-end frames/s
   and request latency, and the device's busy share over one request
   from ``torch.profiler``;
5b. YOLOv8n at full width and 640x640 in float (parameters from a CPU
   generator seeded 0, TF32 off): 2 frames on the card against CPU copies
   (the plain path), raw and decoded, max |d| <= 1e-3 of max |raw| on the
   raw outputs; then 8 requests of 16 frames through ``yolo.forward``
   (frames/s, request latency on the host clock ending in a synchronise)
   and the request's bound (its conv FLOPs at the f32 peak); then the
   request as served, ``yolo.request``: the weights laid out and the
   decode's constants built once (``yolo.program``), each request shape
   captured once into a CUDA graph and replayed (``GraphedForward``).
   Every served output, decoded and one raw, must be ``torch.equal`` to
   ``yolo.forward``'s; the 16-frame shape must capture one graph, its
   repeats none, an 8-frame request exactly one more; a foreign tree and
   CPU parameters must be refused (capture seconds and the capture's
   peak memory logged).  Then 12 interleaved rounds of the 8 requests,
   eager and graphed, timed by ``benchmarks_torch.spread``'s ``timed``
   (wall: n, median, IQR/median; round medians' max/min; enqueue), one
   traced request of each (device ms by ``spread.traced``; host share
   1 - traced / median wall; frames/s), and one request of each under
   ``torch.profiler`` (the share of its profiled wall, launches by the
   trace, top rows);
6. the flash-attention kernel against its plain version: gemma3-1b's
   prefill shapes (B=4, H=4, MQA, S=2048, hd=288) in bf16 and f32, with
   the 512 window and global, and ragged shapes (S = 1000, 300, 100, 1;
   hd 16/64/100/128/256/288/320, f32 at 256, 288 and 320 too; softcap;
   non-causal; GQA groups of 1, 3, 4 and 8), then the other families'
   prefill shapes in bf16 (hd 64 GQA 24/8 and 64/4; hd 64 non-causal at
   S = 1,500; hd 256 MQA with a 2,048 window at S = 4,096; hd 256 MQA at
   S = 512; a ragged hd 200 on the 16-step instance); each check logs
   the instance that ran it and its max |d| (bf16 up to hd 128 on the
   wgmma instance, to hd 288 on the mma.sync tensor cores, f32 within its
   plan on the f32 tensor-core instance, wider heads of both on the CUDA
   cores), and the Python mirror of the four-way dispatch rule is held
   against the C entry's;
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
   rates, time to first token and decode-step latency.  ``Server``'s
   decode step is replayed from a CUDA graph (``GraphedDecode``, the
   reference's ``jax.jit``), captured once per batch shape: the first
   batch's prompts are served again through it and through the same
   server with the plain step (``graph_against_plain``): greedy tokens
   equal, logits ``torch.equal`` or within ``GRAPH_LOGIT_TOL``, 0
   retries, no launch counted in any decode step, both paths' mean step
   ms and each capture's seconds logged (also in phases 14 and 15).
   ``Server``'s prefill is replayed from a CUDA graph a prompt shape
   (``GraphedPrefill``, the reference's ``jax.jit``; every capture in one
   memory pool, every width's outputs copied into one set of static
   outputs a batch size), captured by the first call of a width, whose
   time to first token includes it and which returns the capture's
   warm-up, so the counted run's flash launches are 26 a prefill; the
   same prompts are served again through it and through the same server
   with the plain prefill (``prefill_graph_against_plain``, also in
   phases 14 and 15): greedy tokens equal, each prefill's logits and
   cache leaves ``torch.equal`` (or within ``GRAPH_LOGIT_TOL`` only where
   the plain prefill is not bit-reproducible run to run), 26 flash
   launches a prefill by the counts and by a trace of one replay, no new
   capture; each capture's seconds and memory (``probe_prefill_captures``:
   held against its static inputs' and outputs' bytes), the pool's
   reserved bytes and one replay's launches by trace against one eager
   prefill's logged.  Then ``prefill_spread`` at (4, 2,048), also in
   phase 14: 8 interleaved rounds of 3 eager and 3 graphed prefills timed
   by ``benchmarks_torch.spread``'s ``timed`` (wall: n, median,
   IQR/median; round medians' max/min; enqueue), one traced prefill of
   each (device ms by ``spread.traced``; host share 1 - traced / median
   wall), the two paths' logits ``torch.equal``; then
   ``prefill_widths_memory``, also in phase 14: 8 more prompt widths at
   batch 4, each captured by its call, must hold no more device memory
   than their static tokens (plus ``PREFILL_WIDTHS_SLACK``) and make no
   new static outputs;
9. the flash kernel's time per prefill of (4, 2048) summed over the 26
   layers at their windows (``kernel_bench.time_case`` over
   ``kernel_bench.flash_cases``, as phase 5), beside its bound, its plain
   version and ``scaled_dot_product_attention`` (the yardstick only), and
   the device busy share over one prefill and one decode step;
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
   port's ``train()``: batch 8 x 256, 120 steps, checkpoints every 20
   into a temporary directory (loss must fall), restore and save timed;
   then an interrupted pair (60 steps, then 120), which must resume from
   60 with its next loss within 10%; 0 retries and 0 rollbacks in every
   run.  On the card ``train()`` replays its step from one CUDA graph
   (``train_loop.GraphedTrainStep``), so these runs drive the graph.
   Then the graph's own gates: a run whose fault hook raises once (1
   retry, losses equal to the full run's), a run whose graph reads a NaN
   embedding table at one step (1 rollback; the next step's static state
   ``torch.equal`` to the checkpoint it restored), and one state and
   batch through two plain steps and one graphed step (``torch.equal`` to
   the plain one where the two plain steps are, else no farther from it
   than the two plain ones are apart); the graphed step's median against
   the plain step's through the same loop, the capture's seconds, one
   replay under ``torch.profiler`` (device time, launches, host share);
   then one plain step of that model under ``torch.profiler``.

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
   a prefill, all on the wgmma instance; prefill and decode rates,
   time to first token, step latency, peak memory; one prefill and one
   decode step under ``torch.profiler`` by kernel class (GEMMs, flash,
   the MoE dispatch's gather/scatter/sort/scan glue); the flash kernel's
   time per prefill against its bound, its plain version and SDPA (as
   phase 9); the graphed step against the plain one (phase 8), then once
   more with a fault hook that raises at decode step
   ``GRAPH_FAULT_STEP``: equal tokens and one retry each (the retry's
   prefill cache is copied into the graph's buffers, and its new prompt
   width is captured before it runs); the graphed prefill against the
   plain one and the eager-against-graphed prefill rounds (phase 8);
15. the other families at full width: falcon-mamba-7b (64 layers) and
   recurrentgemma-9b (38 layers; 4 requests of 2,048-3,072 tokens, so
   its 2,048 window masks) through ``Server`` with 0 and 12 flash
   launches a prefill, each graphed prefill held against the plain one
   (phase 8), each server dropped before its eager profile (its prefill
   pool is not released while it lives); whisper-small (4 x 1,500 frames, 64 tokens, 12
   non-causal and 12 causal launches), paligemma-3b (4 x (256 + 256),
   18 launches) and qwen3-moe-235b-a22b cut to 1 layer (~470 GB in bf16
   at full depth) through the step functions, 32 decode steps (4 for
   qwen3), finite logits, and each distinct flash call of their prefill
   timed again: their flash time a prefill;
16. one training step at full width, 2 layers, 1 x 256 tokens, card
   against CPU with T1's limits, for granite-moe (the backward through
   the dispatch's gathers) and falcon-mamba (through the scan); no
   kernel may launch.
17. this slice's main path, the sharded serving steps: granite-moe at
   full width and depth (phase 14's weights and first 4 prompts,
   left-padded to 4 x 2,048) through ``make_prefill_step`` and
   ``make_decode_step`` unsharded, then on a real one-rank NCCL process
   group (``make_host_mesh()``) with parameters, batch and cache placed by
   ``sharding`` as DTensors under ``activation_mesh``: 32 wgmma
   flash launches a prefill (run shard by shard through ``local_map``), 32
   greedy decode steps whose tokens must equal the unsharded run's; max
   |logit d|, prefill and decode-step times, peak memory;
18. the dry run (``python -m repro_torch.launch.dryrun``) of gemma3-1b and
   granite-moe at every shape, and of gemma2-27b long_500k and
   falcon-mamba-7b prefill_32k (no weight gathered where the reference
   keeps it split), on the
   fake 16x16 mesh, started as subprocesses (no card visible) before
   phase 1 and collected here: each supported cell must end ``ok``; per cell the per-device peak, FLOPs
   and collective bytes by kind, each beside the reference's dry run of
   the same cell (``tests/data/dryrun_reference_pod16x16.json``, made by
   ``tests/data/make_dryrun_reference.py``: there is no jax here) and the
   port / reference ratio (the peak also against the reference's less
   XLA:CPU's f32 copies of its bf16 arguments), the reference's
   collective bytes also counted from a one-layer base (the parity
   target; the reference's own count clamps away every layer of its FSDP
   train cells) with the port's total against that base's, the way the
   embedding lookup took, and ``launch.roofline``'s row (model estimates
   under H100 constants, not measurements);
19. ``examples/torch/serve_lm.py`` and ``schedule_and_run_cnn.py`` on the
   card as subprocesses: each must exit 0 and report kernel launches;
20. this slice's path, the port's benchmark harness.  First its host
   half, a background job (joined here, before the run below, which
   writes the same suites' JSON): ``python -m benchmarks_torch.run
   --frames 16`` with the beyond-paper suites (quality, elastic,
   multi_tenant, replication, serving, sensitivity, partition) must exit
   0 and write their JSON, then the simulator's perf gate, ``python -m
   benchmarks_torch.sim_speed --frames 64 --check BENCH_sim_torch.json``,
   must exit 0 and leave that baseline and the reference's
   ``BENCH_sim.json`` unchanged (sha256).  Then ``python -m
   benchmarks_torch.run fig2 fig3 table1 fig4 yolo kernels`` in a
   subprocess must exit 0; the paper's suites run on the host, and the
   kernel bench launches ``imc_mvm`` at the reference's three shapes and
   f32 flash at its two on the card (each case sets the kernel's launch
   count to 0 before it runs and reports it after: it must be nonzero,
   and every flash launch on the instance the rule names for f32 at hd
   128, the f32 tensor-core instance),
   each case equal to its plain version (``torch.equal``; max |d| <=
   2e-4); then the port's own cases at the served paths' shapes
   (``kernel_bench.served_cases``: bf16 flash at granite-moe's,
   recurrentgemma's and gemma3-1b's prefill layers, every distinct
   ResNet-18-CIFAR conv at batch 256 and its fc), each equal to its plain
   version (``torch.equal``; phase 6's bf16 check), launched, and every
   launch on the instance the rule names (the INT8 cases' timed raw
   launch too), each with warm, L2-cold, plain, library and bound times
   (INT8: CUDA-graph and wrapper times too); the table of kernel, plain,
   library and bound times is printed with the card's name and power
   limit, and the two path sums (launches x µs over ResNet-18's request
   and granite's prefill) beside phases 5's and 14's sums of the same
   cases, timed in this process by the same ``time_case``;
21. the gloo ranks of ``tests/test_torch_sharding.py`` on this machine's
   CPU and PyTorch (``tests/test_torch_gloo_workers.py``, which imports no
   jax, a background job from before phase 1, joined here): the
   3-rank serving and train steps of gemma3-1b and granite-moe, the (2, 2)
   gradients of gemma3-1b, granite-moe, falcon-mamba, recurrentgemma and
   qwen3-moe (an fsdp MoE arch, also served and trained there, by the
   rule's ways and with its fsdp weights kept split, its experts
   exchanged and its embedding lookup's rows exchanged, which it must
   take), gemma2-27b's fsdp embedding lookup under a split batch with
   the table gathered and kept split (the rule forced each way, and by
   its own choice), the sequence-split decode and gemma2-27b's batch-1
   and batch-2 decodes, each within the tests' ``SHARD_RTOL`` of the
   unsharded port and gathering no weight where the reference keeps it
   split; an exception in any rank fails it;
22. the run-to-run spread of the two served paths: ``python -m
   benchmarks_torch.spread`` in a subprocess, 12 interleaved rounds of 8
   ResNet-18 INT8 requests of 256 frames and one granite-moe prefill of 4
   x 2,048 tokens with 32 decode steps (built as phases 4 and 14 build
   them; granite's tokens must be equal in every round), host probes (a
   Python loop, 1,000 CUDA enqueues) and an ``nvidia-smi`` sample of
   clocks, power and temperature each round, then one round traced by
   ``torch.profiler`` (8 decode steps); it must exit 0 and its table (n, median,
   quartiles, IQR/median, the highest percentile with 10 samples beyond
   it, the round medians' min/max, rank correlations with the probes, and
   each call's device time from the trace and host share) is logged; and
   whether the traced round's decode step, now graph replays, sums within
   5% of the eager step's device time (``EAGER_DECODE_DEVICE_MS``); the
   traced round's prefill, a graph replay too, is logged beside the eager
   prefill's device time (``EAGER_PREFILL_DEVICE_MS``).

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
import threading
import time
from contextlib import contextmanager
from pathlib import Path

#: the run's start, for the time account's total (before the heavy imports)
STARTED = time.perf_counter()
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit),
# kept in one place: the port's roofline.
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_F32_FLOPS as F32_FLOPS_PER_S,
    PEAK_FLOPS as BF16_FLOPS_PER_S)
# the kernel bench: its served cases, timed here at the paths' shapes
from benchmarks_torch import kernel_bench as kb  # noqa: E402

BATCH = 256
REQUESTS = 8
LOGIT_RTOL = 1e-4      # max |card - cpu| <= LOGIT_RTOL * max |logits|


def log(msg: str) -> None:
    print(msg, flush=True)


class Account:
    """The run's time account: each phase's wall seconds, each background
    job's own wall and the seconds the main thread waited on it at its
    join, and the total since ``start`` (a ``time.perf_counter()``
    stamp).  Each figure is logged when it is taken."""

    def __init__(self, start: float):
        self.start = start
        self.phase_s: dict = {}
        self.background_s: dict = {}
        self.wait_s: dict = {}

    @contextmanager
    def phase(self, pid: str, name: str):
        t = time.perf_counter()
        yield
        self.phase_s[pid] = time.perf_counter() - t
        log(f"phase {pid} ({name}): {self.phase_s[pid]:.1f} s")

    def joined(self, job: str, wall: float, waited: float, walls) -> None:
        """``job`` ran ``wall`` s (``walls``: each command's), and the main
        thread waited ``waited`` s for it at its join."""
        self.background_s[job], self.wait_s[job] = wall, waited
        each = (f" ({', '.join(f'{w:.1f}' for w in walls)} s a command)"
                if len(walls) > 1 else "")
        log(f"join {job}: the job ran {wall:.1f} s{each}, the main thread "
            f"waited {waited:.1f} s for it")

    def record(self) -> dict:
        """The account so far, logged: {phase_s, background_s, wait_s,
        total_s}."""
        total = time.perf_counter() - self.start
        log(f"time account: total {total:.1f} s, phases "
            f"{sum(self.phase_s.values()):.1f} s, waits on background jobs "
            f"{sum(self.wait_s.values()):.1f} s")
        return {"phase_s": self.phase_s, "background_s": self.background_s,
                "wait_s": self.wait_s, "total_s": total}


class Job:
    """``cmds``, one command after another (until one exits nonzero), run
    in the background from the repo root with no card visible, one
    thread, at the lowest CPU priority (the card phases' host-bound
    timings keep the cores they need), their output in ``log_path``.  A
    thread runs them and stamps each one's end, so that ``join`` tells the
    job's own wall, and each command's, from the main thread's wait on
    it."""

    def __init__(self, name: str, cmds, log_path: Path, timeout_s: float):
        self.name, self.log_path, self.timeout_s = name, Path(log_path), timeout_s
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        self.out = open(self.log_path, "w")
        self.lock = threading.Lock()
        self.proc, self.stopped, self.walls = None, False, []
        self.started = time.perf_counter()
        self.ended = None
        self.waiter = threading.Thread(target=self._run, args=(cmds,),
                                       daemon=True)
        self.waiter.start()

    def _run(self, cmds) -> None:
        import os
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        try:
            for cmd in cmds:
                with self.lock:
                    if self.stopped:
                        break
                    t = time.perf_counter()
                    # ``nice`` rather than a ``preexec_fn``: this thread
                    # forks while the main thread runs
                    self.proc = subprocess.Popen(
                        ["nice", "-n", "19", *cmd], cwd=ROOT, env=env,
                        stdout=self.out, stderr=subprocess.STDOUT,
                        start_new_session=True)
                rc = self.proc.wait()
                self.walls.append(time.perf_counter() - t)
                if rc != 0:
                    break
        finally:
            self.ended = time.perf_counter()

    def join(self, account: Account) -> None:
        """Wait for the job until ``timeout_s`` after its start and account
        its wall and the wait.  A job still running then is killed, and it
        or a job that exited nonzero fails the run; the error names its
        log."""
        t = time.perf_counter()
        self.waiter.join(max(self.started + self.timeout_s - t, 0.0))
        waited = time.perf_counter() - t
        where = f"{self.log_path.parent.name}/{self.log_path.name}"
        if self.waiter.is_alive():
            self.stop()
            raise AssertionError(f"{self.name}: still running {self.timeout_s}"
                                 f" s after its start, killed (log in {where})")
        self.out.close()
        account.joined(self.name, self.ended - self.started, waited,
                       self.walls)
        rc = None if self.proc is None else self.proc.returncode
        if rc != 0:
            tail = self.log_path.read_text()[-2000:]
            raise AssertionError(f"{self.name}: exit {rc} (log in {where}): "
                                 f"{tail}")

    def stop(self) -> None:
        """End the job if it still runs, with every process it started
        (its own process group), and start none of its commands after."""
        import os
        import signal
        with self.lock:
            self.stopped = True
            if self.proc is not None and self.proc.poll() is None:
                os.killpg(self.proc.pid, signal.SIGKILL)
        self.waiter.join()
        self.out.close()


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


def wgmma_instances(lib, report):
    """Phase 1 for the wgmma flash instance: its ptxas rows (registers,
    spills, and whether ptxas serialized its wgmma), and the ``HGMMA``
    instructions of each instantiation in the library's SASS (``cuobjdump
    -sass``).  Every instantiation must issue ``HGMMA``; the one on
    granite's path (hd 64, staged by cp.async) must not spill and its wgmma
    must not be serialized."""
    import re
    from repro_torch.kernels import _build, flash_attention as fa
    rows = {fn: dict(r) for fn, r in report.items() if "flash_wg_kernel" in fn}
    if not rows:
        raise AssertionError("ptxas reported no wgmma flash instance")
    log_text = Path(f"{lib}.log").read_text()
    for fn, r in rows.items():
        r["serialized"] = any("C7512" in line and fn in line
                              for line in log_text.splitlines())
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn in rows and "HGMMA" in line:
            rows[fn]["hgmma"] = rows[fn].get("hgmma", 0) + 1
    for fn, r in sorted(rows.items()):
        log(f"ptxas flash wgmma instance {fn}: {r.get('registers')} registers,"
            f" {r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads, wgmma "
            f"{'serialized' if r['serialized'] else 'not serialized'}; "
            f"{r.get('hgmma', 0)} HGMMA in its SASS")
        if not r.get("hgmma"):
            raise AssertionError(f"SASS: {fn} issues no HGMMA")
    tag = f"flash_wg_kernelILi{fa.wg_width(64)}ELb1E"
    path = [r for f, r in rows.items() if tag in f]
    if len(path) != 1 or path[0].get("spill_stores") != 0 \
            or path[0].get("spill_loads") != 0 or path[0]["serialized"]:
        raise AssertionError(f"ptxas: granite's wgmma flash instance {tag} "
                             f"spills, is serialized or is missing: {path}")
    log(f"ptxas: granite's wgmma flash instance ({tag}) does not spill and "
        f"its wgmma are not serialized; every wgmma instance issues HGMMA")
    return rows


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


YOLO_SECOND_BATCH = 8          # a second request shape: one more capture
YOLO_SPREAD_ROUNDS = 12


def yolo_graphed(params, dev, hw, n_requests, batch, second_batch, sync):
    """Phase 5b: the request as served (``yolo.request``: ``GraphedForward``
    on the card, ``forward_programmed`` on the CPU, the rehearsal) on the
    requests ``yolo_serve`` draws, against ``yolo.forward`` on ``dev``.
    Gates: each decoded output, and request 0's raw outputs,
    ``torch.equal`` to the plain forward's; on the card one capture for the
    request shape, none for its repeats, exactly one more for
    ``second_batch`` frames; a foreign tree refused, and parameters off the
    card refused by ``GraphedForward``.  On the card the capture's seconds
    and its peak memory above what was allocated before it
    (``max_memory_allocated``).  Returns (record, request, requests)."""
    import torch
    from repro_torch.models.cnn import yolo
    from repro_torch.tree import tree_map
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    xs = torch.randn((n_requests, batch, hw, hw, 3), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    request = yolo.request(params, (hw, hw))
    graphed = isinstance(request, yolo.GraphedForward)
    sync()
    if cuda:
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    served = [request(params, xs[0])]            # the capture, on the card
    sync()
    rec = {"hw": hw, "requests": n_requests, "batch": batch,
           "graphed": graphed}
    if cuda:
        rec["capture_peak_mib"] = (torch.cuda.max_memory_allocated(dev)
                                   - held) / 2 ** 20
        rec["capture_held_mib"] = (torch.cuda.memory_allocated(dev)
                                   - held) / 2 ** 20
    captures = [len(request.graphs)] if graphed else []
    served += [request(params, x) for x in xs[1:]]
    raw = request(params, xs[0], decode=False)
    if graphed:
        captures.append(len(request.graphs))
    x2 = xs[1, :second_batch]
    served2 = request(params, x2)
    if graphed:
        captures.append(len(request.graphs))
    eager = [yolo.forward(params, x) for x in xs]
    raw_eager = yolo.forward(params, xs[0], decode=False)
    eager2 = yolo.forward(params, x2)
    equal = [bool(torch.equal(a, b)) for a, b in zip(served, eager)]
    raw_equal = len(raw) == len(raw_eager) and all(
        torch.equal(a, b) for a, b in zip(raw, raw_eager))
    equal2 = bool(torch.equal(served2, eager2))
    worst = max((a - b).abs().max().item()
                for a, b in zip(served + [served2], eager + [eager2]))
    for y in served + [served2]:
        if y.device.type != dev.type or not torch.isfinite(y).all():
            raise AssertionError("yolov8n graphed: output off the device or "
                                 "not finite")
    other = tree_map(torch.clone, params)
    try:
        request(other, xs[0])
    except ValueError:
        foreign_refused = True
    else:
        foreign_refused = False
    try:
        yolo.GraphedForward(to_device(params, "cpu"), (hw, hw))
    except ValueError as e:
        cpu_refused = "forward_programmed" in str(e)
    else:
        cpu_refused = False
    del other
    rec.update({"decoded_equal": equal, "raw_equal": bool(raw_equal),
                "second_batch": second_batch,
                "second_batch_equal": equal2, "max_abs_d": worst,
                "captures": captures,
                "capture_s": list(getattr(request, "capture_seconds", [])),
                "foreign_tree_refused": foreign_refused,
                "cpu_params_refused": cpu_refused})
    log(f"yolov8n {hw}x{hw} served ({'graphed' if graphed else 'plain'}) "
        f"against yolo.forward on {dev.type}: decoded torch.equal in "
        f"{sum(equal)} of {n_requests} requests, raw {raw_equal}, "
        f"{second_batch} frames {equal2} (max |d| {worst:.3e}); graphs after "
        f"the first request, the rest and the {second_batch}-frame one: "
        f"{captures}; capture "
        + (", ".join(f"{t:.3f}" for t in rec["capture_s"]) + " s"
           if rec["capture_s"] else "none")
        + (f", peak {rec['capture_peak_mib']:.1f} MiB above the "
           f"{held / 2 ** 20:.1f} allocated before it, "
           f"{rec['capture_held_mib']:.1f} held" if cuda else "")
        + f"; foreign tree refused {foreign_refused}, CPU parameters refused "
        f"{cpu_refused}")
    if not (all(equal) and raw_equal and equal2):
        raise AssertionError("yolov8n graphed: the served request differs "
                             "from yolo.forward")
    if graphed and captures != [1, 1, 2]:
        raise AssertionError(f"yolov8n graphed: graphs {captures} after the "
                             f"first request, its repeats and a "
                             f"{second_batch}-frame request, want [1, 1, 2]")
    if not (foreign_refused and cpu_refused):
        raise AssertionError("yolov8n graphed: a foreign tree or CPU "
                             "parameters were not refused")
    return rec, request, xs


def yolo_spread(params, request, xs, rounds, cuda):
    """Phase 5b's host share: ``rounds`` interleaved rounds (the order
    alternating) of the requests ``xs`` through ``yolo.forward`` (eager)
    and the served request (graphed), each call timed by
    ``benchmarks_torch.spread.timed`` (wall and enqueue); then, on the
    card, one traced request of each (``spread.traced``: the device time
    of its kernels and copies), whose host share is 1 - traced / median
    wall.  Returns the record by path."""
    import numpy as np
    from benchmarks_torch.spread import summary, timed, traced
    from repro_torch.models.cnn import yolo
    calls = {"eager": lambda x: yolo.forward(params, x),
             "graphed": lambda x: request(params, x)}
    samples = {name: [] for name in calls}
    round_medians = {name: [] for name in calls}
    for r in range(rounds):
        for name in (calls if r % 2 == 0 else reversed(calls)):
            got = []
            call = timed(calls[name], got, cuda)
            for x in xs:
                call(x)
            samples[name] += got
            round_medians[name].append(float(np.median(got, axis=0)[0]) * 1e3)
    batch = xs.shape[1]
    out = {}
    for name, fn in calls.items():
        wall = summary([w * 1e3 for w, _ in samples[name]])
        meds = round_medians[name]
        rec = {"wall_ms": wall,
               "enqueue_ms": summary([e * 1e3 for _, e in samples[name]]),
               "round_medians_ms": meds,
               "round_max_over_min": max(meds) / min(meds),
               "frames_per_s": batch / wall["median"] * 1e3}
        if cuda:
            device_ms = []
            traced(fn, device_ms)(xs[0])
            rec["traced_device_ms"] = device_ms[0]
            rec["host_share"] = 1 - device_ms[0] / wall["median"]
        out[name] = rec
        log(f"yolov8n {name}: wall n {wall['n']} median {wall['median']:.3f} "
            f"ms, IQR/median {wall['iqr_over_median']:.4f}; round medians "
            f"max/min {rec['round_max_over_min']:.4f}; enqueue median "
            f"{rec['enqueue_ms']['median']:.3f} ms; "
            + (f"traced device {rec['traced_device_ms']:.3f} ms, host share "
               f"{100 * rec['host_share']:.1f}%; " if cuda else "")
            + f"{rec['frames_per_s']:.1f} frames/s")
    return out


def yolo_profiles(params, request, x):
    """One eager (``yolo.forward``) and one graphed request under
    ``torch.profiler``: the wall under the profiler, the kernels' and
    copies' device ms, their share of that profiled wall (not the host
    share: the profiler's own cost is in the wall), the launches by the
    trace and the top rows."""
    from repro_torch.models.cnn import yolo
    out = {}
    for name, fn in (("eager", lambda: yolo.forward(params, x)),
                     ("graphed", lambda: request(params, x))):
        wall, busy, rows = profile_kernels(fn, top=None)
        out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "launches": sum(r["calls"] for r in rows),
                     "top": rows[:8]}
        log(f"profile of one {name} yolov8n request ({x.shape[0]} frames): "
            f"wall {wall:.3f} ms under the profiler, kernels and copies "
            f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the profiled wall) in "
            f"{out[name]['launches']} launches")
        for row in rows[:8]:
            log(f"  {row['ms']:9.3f} ms  x{row['calls']:<4d} {row['name'][:70]}")
    return out


# ---------------------------------------------------------------------------
# LM serving path (gemma3-1b) and its flash-attention kernel
# ---------------------------------------------------------------------------

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


def flash_check(q, k, v, causal, window, softcap, label, errs):
    """Kernel against its plain version on the same inputs; keeps in
    ``errs`` the largest tight error (f32 inputs, or bf16 against the f32
    upcast) of the instance that ran, which (by its launch count) must be
    the one the dispatch rule names."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ref
    flash_attention = fa.flash_attention
    before = dict(flash_attention.instance_launches)
    got = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    ran = [n for n, c in flash_attention.instance_launches.items()
           if c != before[n]]
    want_inst = fa.instance(q.dtype, q.shape[3])
    if ran != [want_inst]:
        raise AssertionError(f"flash_attention {label}: ran {ran}, the rule "
                             f"names {want_inst}")
    err, err16 = ref.check_flash(got, q, k, v, causal, window, softcap, label)
    line = (f"check flash_attention {label} [{ran[0]}]: max |d| {err:.2e} "
            f"(f32 plain)")
    if err16 is not None:
        line += f", {err16:.2e} (bf16 plain)"
    log(line)
    errs[ran[0]] = max(errs.get(ran[0], 0.0), err)


#: B, H, KV, S, hd, causal, window, path layout: the other LM families'
#: prefill shapes (granite-moe and qwen3-moe, whisper's non-causal encoder,
#: on the wgmma instance; recurrentgemma's 2,048 window, paligemma's
#: prefix + text) and a ragged case on the 16-step instance
FAMILY_FLASH_SHAPES = [(4, 24, 8, 2048, 64, True, None, True),
                       (2, 64, 4, 2048, 64, True, None, True),
                       (4, 12, 12, 1500, 64, False, None, True),
                       (2, 16, 1, 4096, 256, True, 2048, True),
                       (4, 8, 1, 512, 256, True, None, True),
                       (1, 3, 1, 1000, 200, True, None, False)]


def flash_checks(dev, hd_path, local_window):
    """Phase 6: the flash kernel against its plain version at the serving
    path's shapes (both dtypes, window and global) and at ragged ones.
    Returns each instance's largest error against the f32 plain version."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    rule = _build.load("flash_attention", "flash_attention_instance",
                       [ctypes.c_int, ctypes.c_int])
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for hd in (0, 8, 16, 64, 100, 128, 129, 200, 256, 288, 289, 300, 320,
                   512):
            if fa.INSTANCES.get(rule(code, hd)) != fa.instance(dtype, hd):
                raise AssertionError(f"flash dispatch: the C rule and "
                                     f"instance() differ at {dtype} {hd}")
    log("check flash dispatch: instance() agrees with the C rule for the "
        "four instances")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        for window in (local_window, None):
            qkv = flash_inputs(gen, dev, PATH_B, 4, 1, PATH_S, hd_path, dtype,
                               path_layout=True)
            flash_check(*qkv, True, window, None,
                        f"path {str(dtype)[6:]} window {window}", errs)
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
        # bf16 on the wgmma instance: stablelm-1.6b's width with GQA, groups
        # of 1, 3 and 8 query heads a KV head (ragged S, S = 1, softcap),
        # rows that are not 16-byte aligned (hd 100, also with a group);
        # bf16 on the tensor-core instance: hd 288 with softcap, S = 1;
        # bf16 and f32 wider than the register plans, on the CUDA cores (f32
        # at hd 288 above too)
        (2, 8, 2, 1000, 64, torch.bfloat16, True, None, None, 1.0),
        (1, 3, 1, 257, 64, torch.bfloat16, True, None, None, 1.0),
        (2, 6, 2, 1, 64, torch.bfloat16, True, None, None, 1.0),
        (1, 8, 1, 1000, 64, torch.bfloat16, True, None, 2.0, 1.0),
        (1, 6, 2, 300, 100, torch.bfloat16, True, 100, None, 1.0),
        (1, 4, 1, 1000, 288, torch.bfloat16, True, 512, 2.0, 1.0),
        (1, 2, 2, 300, 100, torch.bfloat16, False, None, None, 1.0),
        (1, 2, 1, 1, 288, torch.bfloat16, True, None, None, 1.0),
        (1, 2, 1, 300, 320, torch.bfloat16, True, 128, None, 1.0),
        (1, 2, 1, 300, 320, torch.float32, True, 128, None, 1.0),
        # f32 at the f32 tensor-core instance's widest plan, with a window
        (2, 3, 1, 1000, 256, torch.float32, True, 512, None, 1.0),
    ]
    for B, H, KV, S, hd, dtype, causal, window, softcap, scale in ragged:
        qkv = flash_inputs(gen, dev, B, H, KV, S, hd, dtype, path_layout=False,
                           scale=scale)
        label = (f"({B},{H},{KV},{S},{hd}) {str(dtype)[6:]} causal={causal} "
                 f"window={window} softcap={softcap}")
        flash_check(*qkv, causal, window, softcap, label, errs)
    for B, H, KV, S, hd, causal, window, path_layout in FAMILY_FLASH_SHAPES:
        qkv = flash_inputs(gen, dev, B, H, KV, S, hd, torch.bfloat16,
                           path_layout=path_layout)
        label = (f"({B},{H},{KV},{S},{hd}) bfloat16 causal={causal} "
                 f"window={window} ({kb.plan(hd)})")
        flash_check(*qkv, causal, window, None, label, errs)
    return errs


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
    ``timed_steps``, its prefill graph's captures, the warm-up's
    included, recorded under ``captures`` by ``probe_prefill_captures``),
    the requests and
    the timing record.  Serving them is left to the caller, which resets
    the launch counts just before."""
    import numpy as np
    import torch
    from repro_torch.models.lm import transformer
    from repro_torch.runtime.serve_loop import Request, Server
    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(0)
    s_max = lens[1] + max_new
    server = Server(cfg, params, max_batch=max_batch, s_max=s_max)
    captures = probe_prefill_captures(server)
    # warm-up (library handles, allocator) before the counted run
    server.serve([Request(-1, torch.arange(64), max_new=2)])
    sync()
    reqs = [Request(i, torch.from_numpy(rng.integers(0, cfg.vocab, int(n))),
                    max_new=max_new)
            for i, n in enumerate(rng.integers(lens[0], lens[1] + 1, n_requests))]
    rec = timed_steps(server, sync)
    rec["captures"] = captures
    return server, reqs, rec


def log_port_cases(cases, recs, total, label):
    """Logs each port case of one path (``kernel_bench.time_path``'s
    records) and their sum (µs)."""
    log(f"  {'case':<58s}" + "".join(f"{f[:-3]:>10s}"
                                     for f in kb.SUM_FIELDS)
        + "  x path, bound by, instance, max |d|, library")
    for case in cases:
        rec = recs[case.key]
        steps = f", {rec['plan']}" if "plan" in rec else ""
        log(f"  {kb.port_row(case.key, rec)}  x{case.path_launches}, "
            f"{rec['bound']}, {rec['instances']}{steps}, "
            f"{rec['max_abs_err']:.2e}, {rec['library']}")
    log(f"  {kb.port_row(label, total)}  {total['path_launches']} launches, "
        f"{total['bound']}")


def path_ms(total) -> dict:
    """A path sum's kernel, plain, library and bound times in ms, and what
    bounds it, for the ``kernels`` line."""
    return {"ms": total["kernel_us"] / 1e3,
            "plain_ms": total["plain_us"] / 1e3,
            "library_ms": (None if total.get("library_us") is None
                           else total["library_us"] / 1e3),
            "bound_ms": total["bound_us"] / 1e3, "bound_by": total["bound"]}


#: the ``kernels`` line's fields of a flash path (``flash_timings``)
FLASH_MS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def flash_timings(dev, cfg, B=None, S=None):
    """Phase 9 (and 14-15): per prefill of (B, S) (default (PATH_B,
    PATH_S)), ``kernel_bench.time_case`` of bf16 flash at each attention
    layer's window (those of the config's first segment), summed over the
    layers: the kernel bench's own cases (``kernel_bench.flash_cases``),
    run here.  Returns the records, their sum (µs) and ``path_ms``."""
    import torch
    B, S = B or PATH_B, S or PATH_S
    cases = kb.flash_cases(cfg, B, S, f"{cfg.name}_prefill")
    recs, total = kb.time_path(cases, dev,
                               torch.Generator(device=dev).manual_seed(11))
    log(f"per {cfg.name} prefill ({B}, {S}), {total['path_launches']} "
        f"attention layers (hd {cfg.hd}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads; µs):")
    log_port_cases(cases, recs, total, "per prefill")
    return {"cases": recs, "sum_us": total, **path_ms(total)}


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
# the main path: INT8 ResNet requests, graphed and plain
# ---------------------------------------------------------------------------

#: the INT8 kernels' names in a profiler trace
INT8_TRACE_NAMES = (("imc_conv2d", "imc_conv2d_kernel"),
                    ("imc_mvm", "imc_mvm_kernel"))


def check_cnn_launches(label, g, batch, n_requests, launches, by_instance):
    """The wrappers' counts over ``n_requests`` requests: one conv launch a
    CONV node and one mvm launch a MVM node each request, every conv on the
    instance the rule names for its shape (x 16-byte aligned)."""
    from repro_torch.core.graph import OpKind
    from repro_torch.kernels import conv2d
    want = (g.num_nodes(OpKind.CONV) * n_requests,
            g.num_nodes(OpKind.MVM) * n_requests)
    if tuple(launches) != want:
        raise AssertionError(f"{label}: launches {tuple(launches)}, expected "
                             f"{want}")
    want_inst = dict.fromkeys(by_instance, 0)
    for c in kb.conv_shapes(g, batch):
        want_inst[conv2d.conv_instance(c[3], c[4], True)] += n_requests
    if by_instance != want_inst:
        raise AssertionError(f"{label}: conv launches by instance "
                             f"{by_instance}, the rule names {want_inst}")


def trace_launches(rows) -> dict:
    """Launches of each INT8 kernel in a profile's rows (by kernel name)."""
    return {name: sum(r["calls"] for r in rows if key in r["name"])
            for name, key in INT8_TRACE_NAMES}


def serve_cnn(cfg, g, n_requests, label, dev, batch, sync):
    """Phase 4: ``n_requests`` INT8 requests of ``batch`` frames through
    the request as served (``executor.int8_request``: ``GraphedExecute``
    on the card, the plain ``execute`` on the CPU, the rehearsal;
    parameters from seed 0,
    calibrated on a batch from a generator on ``dev`` seeded 1, which then
    draws the requests; captured on a calibration batch before the counts
    are set to 0), then the same requests through the plain ``execute``
    on ``dev``.  Gates: the counts (``check_cnn_launches``), finite logits
    of the right shape, each request's logits ``torch.equal`` to the plain
    ones, and request 0 against the plain path on CPU copies within
    ``LOGIT_RTOL`` of max |logit| with the same top-1.  Returns (record,
    (request, params, scales, x)) for ``profile_cnn``."""
    import torch
    from repro_torch.kernels.conv2d import imc_conv2d
    from repro_torch.kernels.imc_mvm import imc_mvm
    from repro_torch.models import quant
    from repro_torch.models.cnn import executor, resnet
    params = resnet.init(torch.Generator().manual_seed(0), cfg, device=dev)
    data = torch.Generator(device=dev).manual_seed(1)
    x_cal = torch.randn((batch, 32, 32, 3), generator=data, device=dev)
    scales = quant.calibrate_resnet(params, x_cal, cfg)
    xs = torch.randn((n_requests, batch, 32, 32, 3), generator=data,
                     device=dev)
    request = executor.int8_request(g, params, scales)
    request(params, x_cal)
    executor.execute(g, params, x_cal, mode="int8", act_scales=scales)
    sync()
    zero_counts()

    def timed(fn):
        outs, lat = [], []
        t_all = time.perf_counter()
        for x in xs:
            t = time.perf_counter()
            outs.append(fn(x))
            sync()
            lat.append(time.perf_counter() - t)
        return outs, lat, time.perf_counter() - t_all
    outs, lat, total = timed(lambda x: request(params, x))
    launches = (imc_conv2d.launches, imc_mvm.launches)
    by_inst = dict(imc_conv2d.launches_by_instance)
    mvm_inst = dict(imc_mvm.launches_by_instance)
    check_cnn_launches(label, g, batch, n_requests, launches, by_inst)
    staging = [sum(v for k, v in by_inst.items() if k.startswith(st))
               for st in ("cp_async", "gather")]
    log(f"{label}: {n_requests} requests x {batch} frames; launches conv "
        f"{launches[0]} mvm {launches[1]} ({launches[0] // n_requests} + "
        f"{launches[1] // n_requests} per request); conv by instance {by_inst} "
        f"(cp.async {staging[0]}, gather {staging[1]}); mvm by instance "
        f"{mvm_inst}")
    for y in outs:
        if y.shape != (batch, cfg["num_classes"]) \
                or not torch.isfinite(y).all():
            raise AssertionError(f"{label}: bad logits {tuple(y.shape)}")
    plain, plain_lat, plain_total = timed(lambda x: executor.execute(
        g, params, x, mode="int8", act_scales=scales))
    equal = [bool(torch.equal(a, b)) for a, b in zip(outs, plain)]
    worst = max((a - b).abs().max().item() for a, b in zip(outs, plain))
    log(f"{label}: served against the plain execute on {dev.type}: logits "
        f"torch.equal in {sum(equal)} of {n_requests} requests (max |d| "
        f"{worst:.3e})")
    if not all(equal):
        raise AssertionError(f"{label}: the served request differs from the "
                             f"plain one")
    # the plain path on CPU copies
    y_cpu = executor.execute(g, to_device(params, "cpu"), xs[0].cpu(),
                             mode="int8", act_scales=scales)
    y_dev = outs[0].cpu()
    dmax = (y_dev - y_cpu).abs().max().item()
    lmax = y_cpu.abs().max().item()
    top1 = bool(torch.equal(y_dev.argmax(-1), y_cpu.argmax(-1)))
    log(f"{label}: served vs cpu plain path: max |d| {dmax:.3e}, "
        f"max |logit| {lmax:.4f}, top-1 identical {top1}")
    if not top1 or dmax > LOGIT_RTOL * lmax:
        raise AssertionError(f"{label}: logits disagree with the plain path")
    capture_s = list(getattr(request, "capture_seconds", []))
    rec = {"frames_per_s": n_requests * batch / total,
           "requests": n_requests, "batch": batch,
           "latency_ms": [t * 1e3 for t in lat],
           "plain_frames_per_s": n_requests * batch / plain_total,
           "plain_latency_ms": [t * 1e3 for t in plain_lat],
           "capture_s": capture_s, "launches": list(launches),
           "conv_by_instance": by_inst, "conv_by_staging": staging,
           "mvm_by_instance": mvm_inst, "logits_equal": equal,
           "cpu_max_abs_d": dmax}
    log(f"{label} int8 served ({'graphed' if capture_s else 'plain'}): "
        f"{rec['frames_per_s']:.1f} frames/s, request latency mean "
        f"{sum(lat) / len(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms; "
        f"plain execute: {rec['plain_frames_per_s']:.1f} frames/s, mean "
        f"{sum(plain_lat) / len(plain_lat) * 1e3:.3f} ms, max "
        f"{max(plain_lat) * 1e3:.3f} ms; capture "
        + (", ".join(f"{t:.3f}" for t in capture_s) + " s" if capture_s
           else "none"))
    return rec, (request, params, scales, xs[0])


def check_trace_launches(label, got, n_conv, n_mvm):
    """The card's own count of one request: ``got`` (``trace_launches``)
    must be ``n_conv`` conv and ``n_mvm`` mvm launches."""
    want = {"imc_conv2d": n_conv, "imc_mvm": n_mvm}
    if got != want:
        raise AssertionError(f"{label}: the trace of one request shows "
                             f"{got} INT8 launches, want {want}")


def profile_cnn(g, request, params, scales, x):
    """One served (graphed) request and one plain ``execute`` request under
    ``torch.profiler``: wall, device busy time, INT8 launches by the trace
    (the graphed one must show one launch a CONV and MVM node), top rows."""
    from repro_torch.core.graph import OpKind
    from repro_torch.models.cnn import executor
    out = {}
    for name, fn in (("graphed", lambda: request(params, x)),
                     ("plain", lambda: executor.execute(
                         g, params, x, mode="int8", act_scales=scales))):
        wall, busy, rows = profile_kernels(fn, top=None)
        launches = trace_launches(rows)
        out[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "launches": sum(r["calls"] for r in rows),
                     "int8_launches": launches, "top": rows[:8]}
        log(f"profile of one {name} request: wall {wall:.3f} ms (under the "
            f"profiler), kernels {busy:.3f} ms in {out[name]['launches']} "
            f"launches; INT8 launches by the trace {launches}")
        for row in rows[:8]:
            log(f"  {row['ms']:9.3f} ms  x{row['calls']:<4d} {row['name'][:70]}")
    check_trace_launches("resnet18_cifar graphed", out["graphed"]["int8_launches"],
                         g.num_nodes(OpKind.CONV), g.num_nodes(OpKind.MVM))
    return out


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
# at 120 steps (past the schedule's 30 warm-up steps, and the resume from
# 60) its checks hold as at 300, in 240 steps of ~200 ms instead of 600
T3_STEPS, T3_BATCH, T3_SEQ, T3_CKPT_EVERY = 120, 8, 256, 20
T3_RESUME_RTOL = 0.10  # loss at the first resumed step against the last one
# the graphed step's fault runs: past the checkpoint at step 20, the hook
# raises once (or the graph reads a NaN table) at step 25
T3_FAULT_STEPS, T3_FAULT_AT = 30, 25
T3_PLAIN_STEPS = 12    # the plain step through the same loop: 11 gaps
T3_GRAPH_TIMED = 10    # graphed calls timed on one state and batch


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
    once read, so at most one run's checkpoints are on disk.  The record
    holds the full run's losses and capture seconds (one graph on the
    card, none on the CPU)."""
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
            "step_s_mean": statistics.fmean(gaps), "losses": full.losses,
            "capture_s": full.capture_seconds,
            "resumed_from": second.resumed_from,
            "loss_at_half": first.losses[-1], "loss_after": second.losses[0],
            "resume_jump": jump, "restore_s": restore_s, "save_s": save_s,
            "ckpt_step": last,
            "retries": [r.retries for r in (full, first, second)],
            "rollbacks": [r.rollbacks for r in (full, first, second)]}


@contextmanager
def loop_step(make):
    """``train()`` with its step made by ``make(cfg, tcfg, device)`` in
    place of ``train_loop.step_for_device``."""
    from repro_torch.runtime import train_loop
    orig = train_loop.step_for_device
    train_loop.step_for_device = make
    try:
        yield
    finally:
        train_loop.step_for_device = orig


def nan_graph(nan_call):
    """A ``GraphedTrainStep`` maker whose step, at its ``nan_call``-th
    call, fills the static embedding table with NaN after the copy-in, so
    that the replay computes a non-finite loss; after every copy-in of
    tensors that are not its static ones it keeps (call, a clone of the
    static parameters and state)."""
    import torch
    from repro_torch.runtime.train_loop import GraphedTrainStep
    from repro_torch.tree import tree_leaves, tree_map

    class NaNAt(GraphedTrainStep):
        made = []

        def __init__(self, cfg, tcfg):
            super().__init__(cfg, tcfg)
            self.calls, self.loaded = 0, []
            NaNAt.made.append(self)

        def load(self, g, params, opt_state, batch):
            fresh = any(a is not b for a, b in zip(
                tree_leaves((params, opt_state)), tree_leaves((g.params, g.opt))))
            super().load(g, params, opt_state, batch)
            if fresh:
                self.loaded.append((self.calls,
                                    tree_map(torch.clone, (g.params, g.opt))))
            if self.calls == nan_call:
                g.params["embed"].fill_(float("nan"))
            self.calls += 1
    return NaNAt


def t3_schedule():
    """T3's schedule, the example's: lr 3e-4, 30 warmup steps, cosine to
    ``T3_STEPS``."""
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=T3_STEPS)


def t3_loop(total, ckpt_every, opt, root, sub):
    """T3's loop config: ``total`` steps, checkpoints every ``ckpt_every``
    into ``root/sub``, no logging."""
    from repro_torch.runtime.train_loop import TrainLoopConfig
    return TrainLoopConfig(total_steps=total, ckpt_every=ckpt_every,
                           ckpt_dir=str(root / sub), log_every=0, opt=opt)


def train_fault_runs(cfg, dev, shape, ckpt_every, opt, root, full_losses,
                     n=T3_FAULT_STEPS, at=T3_FAULT_AT):
    """The graphed loop's fault handling, on the loop of ``full_losses``
    (its model, shape, schedule and checkpoints): ``n`` steps whose hook
    raises once at step ``at`` (1 retry, 0 rollbacks, losses equal to the
    first ``n`` of ``full_losses``), then ``n`` steps whose graph reads a
    NaN table at step ``at`` (1 rollback, 0 retries, the losses before it
    equal to ``full_losses``', a NaN there, finite after; the step after
    it copies the restored checkpoint into the static buffers, and that
    state must be ``torch.equal`` to the checkpoint on disk).  ``at``
    must lie past a checkpoint."""
    import math
    import shutil
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.models.lm import transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import train
    from repro_torch.tree import tree_leaves
    raised = []

    def raise_once(step):
        if step == at and not raised:
            raised.append(step)
            raise RuntimeError("injected fault before the replay")

    rep = train(cfg, shape, t3_loop(n, ckpt_every, opt, root, "retry"),
                fault_hook=raise_once, device=dev)
    shutil.rmtree(root / "retry")
    same = rep.losses == full_losses[:n]
    log(f"train T3 retry run: {rep.retries} retry, {rep.rollbacks} rollbacks, "
        f"{n} losses equal to the full run's: {same}")
    if rep.retries != 1 or rep.rollbacks or not same:
        raise AssertionError(f"train T3 retry run: {rep.retries} retries, "
                             f"{rep.rollbacks} rollbacks, losses "
                             f"{rep.losses} against {full_losses[:n]}")
    make = nan_graph(at)
    with loop_step(lambda c, t, d: make(c, t)):
        nan = train(cfg, shape, t3_loop(n, ckpt_every, opt, root, "nan"),
                    device=dev)
    graph = make.made[-1]
    ck_step = (at // ckpt_every) * ckpt_every
    meta = transformer.init_params(cfg, torch.Generator(), device="meta")
    disk, _ = ckpt.restore(str(root / "nan"), ck_step,
                           {"params": meta, "opt": adamw.init(meta)}, dev)
    shutil.rmtree(root / "nan")
    call, state = graph.loaded[-1]
    restored_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state), tree_leaves((disk["params"], disk["opt"])),
        strict=True))
    before = nan.losses[:at] == full_losses[:at]
    after = all(math.isfinite(x) for x in nan.losses[at + 1:])
    log(f"train T3 NaN run: {nan.rollbacks} rollback, {nan.retries} retries; "
        f"loss at step {at} {nan.losses[at]}, the {at} before it equal to the "
        f"full run's: {before}, the {n - at - 1} after finite: {after}; the "
        f"state copied in at call {call} torch.equal to checkpoint "
        f"{ck_step}: {restored_equal}")
    if (nan.rollbacks != 1 or nan.retries or not math.isnan(nan.losses[at])
            or not before or not after or call != at + 1
            or len(graph.loaded) != 2 or not restored_equal):
        raise AssertionError(f"train T3 NaN run: {nan.rollbacks} rollbacks, "
                             f"{nan.retries} retries, copy-ins at "
                             f"{[c for c, _ in graph.loaded]}, restored "
                             f"state equal {restored_equal}, losses "
                             f"{nan.losses}")
    return {"retry": {"retries": rep.retries, "losses_equal": same},
            "nan": {"rollbacks": nan.rollbacks, "nan_step": at,
                    "restored_step": ck_step, "copied_in_at_call": call,
                    "restored_equal": restored_equal,
                    "losses_before_equal": before}}


def train_plain_loop(cfg, dev, shape, ckpt_every, opt, root,
                     n=T3_PLAIN_STEPS):
    """The plain step on ``dev`` through the same ``train()`` loop for
    ``n`` steps: the median and mean gap between steps."""
    import shutil
    import statistics
    from repro_torch.models.lm import model
    from repro_torch.runtime.train_loop import train
    stamps = []
    with loop_step(lambda c, t, d: model.make_train_step(c, t)):
        rep = train(cfg, shape, t3_loop(n, ckpt_every, opt, root, "plain"),
                    fault_hook=lambda step: stamps.append(time.perf_counter()),
                    device=dev)
    shutil.rmtree(root / "plain")
    if rep.capture_seconds:
        raise AssertionError("train T3 plain run: the loop captured a graph")
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    return {"step_s_median": statistics.median(gaps),
            "step_s_mean": statistics.fmean(gaps), "steps": rep.steps_run}


def max_diffs(x, y) -> dict:
    """Per part of a step's result (loss, params, m, v, step): whether
    every leaf is ``torch.equal``, and the largest |d| over the leaves."""
    import torch
    from repro_torch.tree import tree_leaves
    out = {}
    for name, a, b in (("loss", x[2]["loss"], y[2]["loss"]),
                       ("params", x[0], y[0]), ("m", x[1].m, y[1].m),
                       ("v", x[1].v, y[1].v), ("step", x[1].step, y[1].step)):
        pairs = list(zip(tree_leaves(a), tree_leaves(b), strict=True))
        out[name] = {
            "equal": all(torch.equal(p, q) for p, q in pairs),
            "max_d": max((p.double() - q.double()).abs().max().item()
                         for p, q in pairs)}
    return out


def train_graph_gate(cfg, dev, shape, opt, sync):
    """One state and batch of ``cfg`` through two plain steps and one
    graphed step: where the plain two are ``torch.equal`` in every part,
    the graphed one must be too; else each part's max |graphed - plain|
    must be at most its max |plain - plain|.  Then ``T3_GRAPH_TIMED``
    graphed calls (each reading the loss) timed on the host clock, and one
    under ``torch.profiler``: its device time, launches and host share
    against the timed median."""
    import statistics
    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.lm import model, transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import GraphedTrainStep
    tcfg = model.TrainStepConfig(opt=opt)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = adamw.init(params)
    batch = make_batch(cfg, shape, 0, device=dev)
    plain = model.make_train_step(cfg, tcfg)
    a = plain(params, state, batch)
    b = plain(params, state, batch)
    graphed = GraphedTrainStep(cfg, tcfg)
    g = graphed(params, state, batch)
    sync()
    pp, gp = max_diffs(a, b), max_diffs(g, a)
    deterministic = all(r["equal"] for r in pp.values())
    log(f"train T3 graph gate: plain against plain "
        + ", ".join(f"{k} {'equal' if r['equal'] else r['max_d']}"
                    for k, r in pp.items())
        + "; graphed against plain "
        + ", ".join(f"{k} {'equal' if r['equal'] else r['max_d']}"
                    for k, r in gp.items()))
    if deterministic:
        bad = [k for k, r in gp.items() if not r["equal"]]
    else:
        bad = [k for k, r in gp.items() if r["max_d"] > pp[k]["max_d"]]
    if bad:
        raise AssertionError(f"train T3 graph gate: the graphed step differs "
                             f"from the plain one in {bad}: {gp} (plain "
                             f"against plain {pp})")
    del a, b, g, params, state
    # the loop's way: each call takes the static state the last returned
    captured = next(iter(graphed.graphs.values()))
    p, o = captured.params, captured.opt
    secs = []
    for _ in range(T3_GRAPH_TIMED):
        sync()
        t = time.perf_counter()
        p, o, metrics = graphed(p, o, batch)
        float(metrics["loss"])
        secs.append(time.perf_counter() - t)
    median = statistics.median(secs)
    wall, busy, rows = profile_kernels(
        lambda: float(graphed(p, o, batch)[2]["loss"]), top=None)
    rec = {"plain_vs_plain": pp, "graphed_vs_plain": gp,
           "deterministic": deterministic,
           "capture_s": graphed.capture_seconds[0],
           "step_ms_median": 1e3 * median, "step_ms": [1e3 * x for x in secs],
           "replay_wall_ms": wall, "replay_device_ms": busy,
           "replay_launches": sum(r["calls"] for r in rows),
           "host_share": (1e3 * median - busy) / (1e3 * median),
           "top": rows[:8]}
    graphed.graphs.clear()
    return rec


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
#: phase 14's fault-hook run: the decode step at which the hook raises once
GRAPH_FAULT_STEP = 5
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


def check_flash_counts(counts, per_prefill, prefills, label, hd):
    """The path's launches: ``per_prefill`` flash launches a prefill, all on
    the instance the rule names for bf16 at head width ``hd`` (the wgmma
    instance up to hd 128, the tensor-core instance above), and no INT8
    kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    if prefills == 0 or counts["flash"] != per_prefill * prefills:
        raise AssertionError(f"{label}: {counts['flash']} flash launches for "
                             f"{prefills} prefills, want {per_prefill} each")
    inst = fa.instance(torch.bfloat16, hd)
    if counts["flash_instances"][inst] != counts["flash"]:
        raise AssertionError(f"{label}: flash launches by instance "
                             f"{counts['flash_instances']}, not all on the "
                             f"{inst} instance")
    if counts["conv"] or counts["mvm"]:
        raise AssertionError(f"{label}: the LM path launched an INT8 kernel")


def serve_counted(cfg, dev, n_requests, lens, max_new, max_batch,
                  flash_per_prefill, sync):
    """``cfg`` through ``Server`` (``lm_serve``): the launch counts set to 0
    just before the requests and read just after (a prefill step a
    prefill: a new width's call runs the step once, as the capture's
    warm-up, and a repeated width's replays it), the device's peak memory
    over them, each request's tokens checked; then
    the first batch's prompts again, the graphed decode step held against
    the plain one (``graph_against_plain``, under ``graph`` in the record)
    and the graphed prefill against the plain one
    (``prefill_graph_against_plain``, under ``prefill_graph``; its plain
    side runs before the requests, ``plain_prefills``).  The time to first
    token is the prefill call's, a new width's capture included.  Returns
    (server, record, the first batch's prompts)."""
    import torch
    server, reqs, rec = lm_serve(cfg, dev, n_requests, lens, max_new,
                                 max_batch, sync)
    prompts = [r.prompt for r in reqs[:max_batch]]
    plain = plain_prefills(cfg, server, prompts, max_new, sync)
    probed = len(rec["captures"])
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats = server.serve(reqs)
    sync()
    counts = read_counts()
    new_widths = rec["captures"][probed:]
    check_flash_counts(counts, flash_per_prefill, stats.prefills, cfg.name,
                       cfg.hd)
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
        "prefill_captures": len(new_widths),
        "prefill_capture_s": [c["seconds"] for c in new_widths],
        "flash_launches": counts["flash"],
        "flash_instances": counts["flash_instances"],
        "wall_s": stats.wall_seconds, "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "prefill_tokens": pre_tok, "prefill_tok_per_s": pre_tok / pre_s,
        "ttft_ms": [t * 1e3 for t, _ in rec["prefill"]],
        "decode_tok_per_s": dec_tok / sum(dec),
        "decode_step_ms_mean": sum(dec) / len(dec) * 1e3,
        "decode_step_ms_max": max(dec) * 1e3}
    log(f"{cfg.name} serve ({cfg.n_layers} layers): {out['requests']} requests "
        f"(prompts {out['prompt_lens']}), {stats.prefills} prefills "
        f"({len(new_widths)} of a new width, captured by the call), "
        f"{stats.decode_steps} decode steps, flash launches "
        f"{counts['flash']} ({flash_per_prefill} per prefill step; by instance "
        f"{counts['flash_instances']}), wall {stats.wall_seconds:.3f} s, peak "
        f"memory {out['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  prefill {out['prefill_tok_per_s']:.1f} tok/s (padded tokens), time "
        f"to first token {', '.join(f'{t:.1f}' for t in out['ttft_ms'])} ms "
        f"(captures included: "
        f"{', '.join(f'{t:.3f}' for t in out['prefill_capture_s'])} s); "
        f"decode {out['decode_tok_per_s']:.1f} tok/s, step "
        f"{out['decode_step_ms_mean']:.3f} ms mean, "
        f"{out['decode_step_ms_max']:.3f} ms max")
    out["graph"] = graph_against_plain(cfg, server, prompts, max_new, sync)
    out["prefill_graph"] = prefill_graph_against_plain(
        cfg, server, prompts, max_new, sync, flash_per_prefill, plain,
        rec["captures"])
    return server, out, prompts


#: graphed against plain decode logits (and prefill outputs, where the plain
#: prefill is not bit-reproducible run to run): max |d| <= GRAPH_LOGIT_TOL *
#: max |x| where they are not ``torch.equal`` (a replay runs the kernels the
#: plain step launches, on the same inputs, in the same order; only a
#: library that picked another algorithm under capture would move a bf16
#: logit, by an ulp or two: 2^-7 of its magnitude)
GRAPH_LOGIT_TOL = 1e-2
#: phases 8 and 14's further prompt widths at PATH_B, each captured by a
#: call: together they may hold no more than their static tokens (each
#: allocation rounded to the allocator's 512 bytes) and this slack
PREFILL_MORE_WIDTHS = (96, 224, 352, 480, 608, 736, 864, 992)
PREFILL_WIDTHS_SLACK = 1 << 20
#: phases 8 and 14's eager-against-graphed prefill rounds at (PATH_B,
#: PATH_S): rounds, and calls of each path a round
PREFILL_SPREAD_ROUNDS = 8
PREFILL_SPREAD_CALLS = 3


def serve_recorded(server, prompts, max_new, sync, fault_at=None):
    """``prompts`` through ``server`` as it stands, each decode call timed
    on the host clock ending in ``sync`` and its logits kept (the graph's
    are overwritten by its next replay); with ``fault_at``, the fault hook
    raises once, at that decode step.  Every launch count must stay as it
    is across each decode call: no hand-written kernel runs in a decode
    step, and a replay would not count one.  Returns (tokens, logits,
    seconds, stats)."""
    from repro_torch.runtime.serve_loop import Request
    logits, secs, dec, fired = [], [], server.decode, []

    def call(params, tok, cache):
        before = read_counts()
        t = time.perf_counter()
        out = dec(params, tok, cache)
        sync()
        secs.append(time.perf_counter() - t)
        if read_counts() != before:
            raise AssertionError(f"a kernel launch counted in a decode step: "
                                 f"{before} -> {read_counts()}")
        logits.append(out[0].clone())
        return out

    def hook(step):
        if step == fault_at and not fired:
            fired.append(step)
            raise RuntimeError("injected decode fault")

    server.decode = call
    server.fault_hook = hook if fault_at is not None else None
    try:
        reqs = [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]
        stats = server.serve(reqs)
    finally:
        server.decode, server.fault_hook = dec, None
    return [r.out_tokens for r in reqs], logits, secs, stats


def graph_against_plain(cfg, server, prompts, max_new, sync, fault_at=None):
    """The graphed ``Server`` (its decode step replayed from a CUDA graph,
    ``GraphedDecode``) against the same server with ``decode`` set back to
    the plain ``model.make_decode_step(cfg)``, on the same prompts (one
    batch): greedy tokens equal, each step's logits ``torch.equal`` or
    within ``GRAPH_LOGIT_TOL``, 0 retries each (1 with ``fault_at``, the
    hook raising once at that step), no new capture (the batch's graph is
    the one the counted run captured); both paths' mean decode-step ms
    logged.  On the CPU (the rehearsal) both sides are the plain step."""
    import torch
    from repro_torch.models.lm import model
    graph = server.graph
    if server.device.type == "cuda" and graph is None:
        raise AssertionError(f"{cfg.name}: Server on the card has no graph")
    captured = len(graph.graphs) if graph is not None else 0
    g_tok, g_log, g_s, g_stats = serve_recorded(server, prompts, max_new,
                                                sync, fault_at)
    graphed = server.decode
    server.decode = model.make_decode_step(cfg)
    try:
        p_tok, p_log, p_s, p_stats = serve_recorded(server, prompts, max_new,
                                                    sync, fault_at)
    finally:
        server.decode = graphed
    retries = 0 if fault_at is None else 1
    equal = len(g_log) == len(p_log) and all(
        torch.equal(a, b) for a, b in zip(g_log, p_log))
    rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()
               ).item() for a, b in zip(g_log, p_log))
    rec = {"requests": len(prompts), "max_new": max_new, "fault_at": fault_at,
           "tokens_equal": g_tok == p_tok, "logits_equal": equal,
           "max_rel_logit_d": rel,
           "retries": [g_stats.retries, p_stats.retries],
           "graph_step_ms_mean": sum(g_s) / len(g_s) * 1e3,
           "plain_step_ms_mean": sum(p_s) / len(p_s) * 1e3,
           "graphs": captured,
           "capture_s": list(graph.capture_seconds) if graph else []}
    log(f"{cfg.name} graphed decode against the plain step"
        f"{f' (a fault at step {fault_at})' if fault_at is not None else ''}: "
        f"{len(prompts)} requests, {len(g_s)} decode steps; tokens equal "
        f"{rec['tokens_equal']}, logits torch.equal {equal} (max |d| / max "
        f"|logit| {rel:.3e}, limit {GRAPH_LOGIT_TOL}), retries "
        f"{rec['retries']}; step {rec['graph_step_ms_mean']:.3f} ms graphed, "
        f"{rec['plain_step_ms_mean']:.3f} ms plain (mean); {captured} graphs "
        f"captured in " + ", ".join(f"{t:.3f}" for t in rec["capture_s"])
        + " s")
    if not rec["tokens_equal"] or (not equal and not rel <= GRAPH_LOGIT_TOL):
        raise AssertionError(f"{cfg.name}: the graphed decode step differs "
                             f"from the plain one")
    if rec["retries"] != [retries, retries]:
        raise AssertionError(f"{cfg.name}: retries {rec['retries']}, want "
                             f"{retries} each")
    if graph is not None and len(graph.graphs) != captured:
        raise AssertionError(f"{cfg.name}: a batch of the captured shapes "
                             f"was captured again")
    return rec


def prefill_graphs(server) -> int:
    """The prompt shapes ``server``'s prefill graph has captured (0 where
    it has none: the CPU, a mesh)."""
    g = server.prefill_graph
    return len(g.graphs) if g is not None else 0


def pool_reserved(pool) -> int:
    """The bytes the caching allocator holds in ``pool``'s segments."""
    import torch
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


def probe_prefill_captures(server) -> list:
    """Wraps the ``capture`` of ``server``'s prefill graph (where it has
    one: the card without a mesh) to record each new prompt shape's
    capture: its shape and host seconds; the allocator's bytes allocated
    just before and just after (``held``: what the width keeps, its static
    inputs and, where its batch size is new, the static outputs) and the
    driver's bytes in use (``torch.cuda.mem_get_info``), which also sees
    the graph's own memory; its static inputs' and outputs' bytes and
    whether the outputs were new.  No call synchronises, so the time to
    first token around it stays the call's.  Returns the list the records
    go to."""
    import torch
    from repro_torch.tree import tree_leaves
    recs, g = [], server.prefill_graph
    if g is None:
        return recs
    capture = g.capture

    def used(dev):
        free, total = torch.cuda.mem_get_info(dev)
        return total - free

    def probed(params, batch):
        if g.key(batch) in g.graphs:
            return capture(params, batch)
        dev = batch["tokens"].device
        outputs = len(g.outputs)
        before = torch.cuda.memory_allocated(dev), used(dev)
        c = capture(params, batch)
        after = torch.cuda.memory_allocated(dev), used(dev)
        recs.append({
            "shape": list(batch["tokens"].shape),
            "seconds": g.capture_seconds[-1],
            "allocated_before": before[0], "allocated_after": after[0],
            "held": after[0] - before[0],
            "driver_used_delta": after[1] - before[1],
            "static_input_bytes": sum(t.nbytes for t in c.batch.values()),
            "static_output_bytes": sum(t.nbytes for t in tree_leaves(c.out)),
            "new_outputs": len(g.outputs) > outputs})
        return c

    g.capture = probed
    return recs


def prefill_record(server, prefill, prompts, max_new, sync):
    """``prompts`` through ``server`` with ``prefill`` as its prefill step
    (and as its prefill graph where ``prefill`` is that graph, else no
    graph), the launch counts set to 0 just before and read just after;
    each prefill's tokens and outputs (the logits, then the cache's
    leaves) kept, cloned: a graph's are overwritten by its next replay.
    Returns (tokens, prefills, stats, counts)."""
    from repro_torch.runtime.serve_loop import Request
    from repro_torch.tree import tree_leaves
    outs, saved = [], (server.prefill, server.prefill_graph)

    def call(params, batch):
        logits, cache = prefill(params, batch)
        outs.append((batch["tokens"].clone(),
                     [t.clone() for t in [logits, *tree_leaves(cache)]]))
        return logits, cache

    server.prefill = call
    if prefill is not saved[1]:
        server.prefill_graph = None
    try:
        reqs = [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]
        zero_counts()
        stats = server.serve(reqs)
        sync()
        counts = read_counts()
    finally:
        server.prefill, server.prefill_graph = saved
    return [r.out_tokens for r in reqs], outs, stats, counts


def unequal_outputs(got, want) -> list:
    """(name, max |d|, max |d| / max |want|) of each output of one prefill
    (``prefill_record``'s: the logits, then the cache's leaves) that is
    not ``torch.equal`` to ``want``'s."""
    import torch
    rows = []
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a.shape != b.shape or not torch.equal(a, b):
            d = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            rows.append(("logits" if i == 0 else f"cache leaf {i - 1}", d,
                         d / top if top else float("inf")))
    return rows


def prefill_trace(fn) -> dict:
    """One prefill ``fn()`` under ``torch.profiler``: its launches and flash
    launches by the trace, device ms and the profiled wall."""
    wall, busy, rows = profile_kernels(fn, top=None)
    return {"wall_ms": wall, "device_ms": busy,
            "launches": sum(r["calls"] for r in rows),
            "flash": sum(r["calls"] for r in rows if "flash_" in r["name"])}


def plain_prefills(cfg, server, prompts, max_new, sync):
    """The plain side of ``prefill_graph_against_plain``, run before the
    server's graph captures the prompts' width, so that a plain prefill
    and the graph's pool never hold their memory at once (falcon-mamba's
    pool alone takes ~36 GiB): ``prompts`` through ``server`` with its
    prefill set to the plain ``model.make_prefill_step``
    (``prefill_record``), one more plain prefill of the first batch (the
    outputs that differ from the first one's: the plain prefill is
    bit-reproducible run to run where there are none) and, on the card,
    one under ``torch.profiler``.  Returns the record."""
    from repro_torch.models.lm import model
    from repro_torch.tree import tree_leaves
    plain = model.make_prefill_step(cfg, s_max=server.s_max)
    tokens, outs, stats, counts = prefill_record(server, plain, prompts,
                                                 max_new, sync)
    batch = {"tokens": outs[0][0]}
    logits, cache = plain(server.params, batch)
    rec = {"tokens": tokens, "outs": outs, "stats": stats, "counts": counts,
           "run_to_run": unequal_outputs([logits, *tree_leaves(cache)],
                                         outs[0][1])}
    del logits, cache
    if server.device.type == "cuda":
        rec["trace"] = prefill_trace(lambda: plain(server.params, batch))
    return rec


def prefill_graph_against_plain(cfg, server, prompts, max_new, sync,
                                flash_per_prefill, plain, captures=()):
    """The graphed ``Server`` (its prefill replayed from a CUDA graph a
    prompt shape, ``GraphedPrefill``) against the same server with its
    prefill set back to the plain ``model.make_prefill_step`` (``plain``:
    ``plain_prefills``' record of the same prompts, one batch, whose width
    the counted run captured).  Gates: greedy tokens equal and 0 retries
    each; each prefill's logits and every cache leaf ``torch.equal`` to
    the plain ones, or, only where the plain prefill is not
    bit-reproducible run to run, within ``GRAPH_LOGIT_TOL`` of the
    output's max |x| (which outputs and their max |d| logged); on the card
    ``flash_per_prefill`` flash launches a prefill by the counts over each
    run and by a trace of one replay and of one plain prefill; no new
    capture.  Logged: each capture's seconds and memory (``captures``,
    ``probe_prefill_captures``' records: what it held against its static
    inputs' and outputs' bytes), the shared pool's reserved bytes and the
    launches of one replay by trace against one plain prefill's.  On the
    CPU (the rehearsal) both sides are the plain step and nothing is
    traced."""
    import torch
    from repro_torch.tree import tree_leaves
    graph = server.prefill_graph
    cuda = server.device.type == "cuda"
    if cuda and graph is None:
        raise AssertionError(f"{cfg.name}: Server on the card has no prefill "
                             f"graph")
    captured = prefill_graphs(server)
    g_tok, g_out, g_stats, g_counts = prefill_record(
        server, graph if graph is not None else server.prefill, prompts,
        max_new, sync)
    p_out, p_stats = plain["outs"], plain["stats"]
    if len(g_out) != len(p_out) or not all(
            torch.equal(a[0], b[0]) for a, b in zip(g_out, p_out)):
        raise AssertionError(f"{cfg.name}: the graphed and plain runs "
                             f"prefilled other tokens")
    unequal = [(i, *row) for i, (a, b) in enumerate(zip(g_out, p_out))
               for row in unequal_outputs(a[1], b[1])]
    rec = {"requests": len(prompts), "max_new": max_new,
           "prefills": [g_stats.prefills, p_stats.prefills],
           "retries": [g_stats.retries, p_stats.retries],
           "tokens_equal": g_tok == plain["tokens"],
           "outputs_equal": not unequal,
           "unequal": [list(u) for u in unequal],
           "plain_reproducible": not plain["run_to_run"],
           "plain_run_to_run": [list(u) for u in plain["run_to_run"]],
           "flash_launches": [g_counts["flash"], plain["counts"]["flash"]],
           "graphs": captured, "captures": list(captures),
           "capture_s": [c["seconds"] for c in captures]}
    if cuda:
        rec["pool_reserved"] = pool_reserved(graph.pool)
    if cuda:
        batch = {"tokens": g_out[0][0]}
        rec["trace_graphed"] = prefill_trace(
            lambda: graph(server.params, batch))
        rec["trace_eager"] = plain["trace"]
    log(f"{cfg.name} graphed prefill against the plain step: "
        f"{len(prompts)} requests, prefills {rec['prefills']}, tokens equal "
        f"{rec['tokens_equal']}, logits and every cache leaf torch.equal "
        f"{not unequal}"
        + ("" if not unequal else " (" + ", ".join(
            f"prefill {i} {name}: max |d| {d:.3e}, / max {r:.3e}"
            for i, name, d, r in unequal[:6]) + ")")
        + f"; the plain prefill run to run "
        + ("bit-reproducible" if rec["plain_reproducible"] else
           "not bit-reproducible (" + ", ".join(
               f"{name}: max |d| {d:.3e}"
               for name, d, _ in plain["run_to_run"][:6]) + ")")
        + f"; flash launches {rec['flash_launches']} (graphed, plain; "
        f"{flash_per_prefill} a prefill); {prefill_graphs(server)} graphs"
        + (" captured in " + ", ".join(f"{t:.3f}" for t in rec["capture_s"])
           + " s" if rec["capture_s"] else ""))
    for c in rec["captures"]:
        log_capture(c)
    if "pool_reserved" in rec:
        log(f"  the shared pool holds {rec['pool_reserved'] / 2**20:.1f} MiB")
    for name in ("graphed", "eager"):
        if f"trace_{name}" in rec:
            t = rec[f"trace_{name}"]
            log(f"  one {name} prefill of {list(g_out[0][0].shape)} under the "
                f"profiler: {t['launches']} launches ({t['flash']} flash), "
                f"{t['device_ms']:.3f} ms of device time in a "
                f"{t['wall_ms']:.3f} ms profiled wall")
    if not rec["tokens_equal"]:
        raise AssertionError(f"{cfg.name}: the graphed prefill's tokens differ "
                             f"from the plain one's")
    if unequal and (rec["plain_reproducible"] or not all(
            r <= GRAPH_LOGIT_TOL for _, _, _, r in unequal)):
        raise AssertionError(f"{cfg.name}: the graphed prefill's outputs "
                             f"differ from the plain one's: {unequal[:6]}")
    if rec["retries"] != [0, 0] or g_stats.prefills != p_stats.prefills:
        raise AssertionError(f"{cfg.name}: retries {rec['retries']}, "
                             f"prefills {rec['prefills']}")
    if prefill_graphs(server) != captured:
        raise AssertionError(f"{cfg.name}: a prompt width already captured "
                             f"was captured again")
    if cuda:
        want = flash_per_prefill * g_stats.prefills
        traced = [rec[f"trace_{n}"]["flash"] for n in ("graphed", "eager")]
        if rec["flash_launches"] != [want, want] or traced != [
                flash_per_prefill] * 2:
            raise AssertionError(f"{cfg.name}: flash launches "
                                 f"{rec['flash_launches']} by count, "
                                 f"{traced} a prefill by trace (graphed, "
                                 f"eager); want {flash_per_prefill} a "
                                 f"prefill")
    return rec


def log_capture(c) -> None:
    log(f"  capture of {c['shape']} in {c['seconds']:.3f} s: allocated "
        f"{c['allocated_before'] / 2**20:.1f} -> "
        f"{c['allocated_after'] / 2**20:.1f} MiB, held "
        f"{c['held'] / 2**20:.3f} MiB against static inputs of "
        f"{c['static_input_bytes'] / 2**20:.3f} MiB and static outputs of "
        f"{c['static_output_bytes'] / 2**20:.1f} MiB ("
        f"{'new' if c['new_outputs'] else 'shared'}); the driver's bytes in "
        f"use {c['driver_used_delta'] / 2**20:+.1f} MiB")


def prefill_widths_memory(cfg, server, batch, widths, sync):
    """Prompts of ``widths`` at ``batch`` (random tokens), each a new width
    that the server's prefill graph captures in the call: the device bytes
    they hold together (allocated after less before, with the tokens
    dropped) must stay within their static tokens' bytes, each rounded up
    to the allocator's 512, plus ``PREFILL_WIDTHS_SLACK``, and no new
    static outputs may be made.  Logged too: the shared pool's reserved
    bytes and the driver's bytes in use before and after, and each
    capture's seconds.  Returns the record."""
    import torch
    from repro_torch.tree import tree_leaves
    g = server.prefill_graph
    if g is None:
        raise AssertionError(f"{cfg.name}: Server on the card has no prefill "
                             f"graph")
    dev = server.device
    gen = torch.Generator(device=dev).manual_seed(5)
    sync()
    n, outputs = len(g.graphs), len(g.outputs)
    free, total = torch.cuda.mem_get_info(dev)
    before = (torch.cuda.memory_allocated(dev), pool_reserved(g.pool),
              total - free)
    for w in widths:
        toks = torch.randint(0, cfg.vocab, (batch, w), device=dev,
                             generator=gen)
        out = server.prefill_graph(server.params, {"tokens": toks})
        if not all(torch.isfinite(t).all() for t in tree_leaves(out)
                   if t.is_floating_point()):
            raise AssertionError(f"{cfg.name}: non-finite prefill outputs at "
                                 f"width {w}")
        del toks, out
    sync()
    free, total = torch.cuda.mem_get_info(dev)
    after = (torch.cuda.memory_allocated(dev), pool_reserved(g.pool),
             total - free)
    new = list(g.graphs.values())[n:]
    inputs = sum(-(-t.nbytes // 512) * 512 for c in new
                 for t in c.batch.values())
    rec = {"batch": batch, "widths": list(widths),
           "captured": len(new), "new_outputs": len(g.outputs) - outputs,
           "held": after[0] - before[0], "static_input_bytes": inputs,
           "pool_reserved": [before[1], after[1]],
           "driver_used": [before[2], after[2]],
           "capture_s": g.capture_seconds[n:]}
    log(f"{cfg.name} prefill at {len(widths)} more widths of batch {batch} "
        f"({widths[0]}-{widths[-1]}): {len(new)} captured in "
        f"{', '.join(f'{t:.3f}' for t in rec['capture_s'])} s; held "
        f"{rec['held'] / 2**20:.3f} MiB against their static tokens' "
        f"{inputs / 2**20:.3f} MiB (+ {PREFILL_WIDTHS_SLACK >> 20} MiB "
        f"allowed), new static outputs {rec['new_outputs']}; the shared "
        f"pool {before[1] / 2**20:.1f} -> {after[1] / 2**20:.1f} MiB, the "
        f"driver's bytes in use {before[2] / 2**20:.1f} -> "
        f"{after[2] / 2**20:.1f} MiB")
    if len(new) != len(widths) or rec["new_outputs"] or \
            rec["held"] > inputs + PREFILL_WIDTHS_SLACK:
        raise AssertionError(f"{cfg.name}: {len(widths)} more prompt widths "
                             f"held {rec['held']} bytes ({len(new)} captured, "
                             f"{rec['new_outputs']} new static outputs)")
    return rec


def prefill_spread(cfg, server, batch, width, rounds, calls, sync):
    """The prefill at (``batch``, ``width``) random tokens, eager (the
    plain step) against graphed (the server's prefill graph, its width
    captured here before the rounds, so that every graphed call replays;
    the plain step on the CPU): ``rounds`` interleaved
    rounds (the order alternating) of ``calls`` calls each, each call
    timed by ``benchmarks_torch.spread``'s ``timed`` (wall ending in
    ``sync``, and enqueue); then, on the card,
    one traced call of each (``spread.traced``: the device time of its
    kernels and copies), whose host share is 1 - traced / median wall.
    The two paths' logits must be ``torch.equal``.  Returns the record by
    path."""
    import numpy as np
    import torch
    from benchmarks_torch.spread import summary, timed, traced
    from repro_torch.models.lm import model
    dev = server.device
    cuda = dev.type == "cuda"
    # the graph itself: ``server.prefill`` may be wrapped (``timed_steps``
    # synchronises after each call)
    graphed = server.prefill_graph
    if cuda and graphed is None:
        raise AssertionError(f"{cfg.name}: Server on the card has no prefill "
                             f"graph")
    toks = torch.randint(0, cfg.vocab, (batch, width), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    b = {"tokens": toks}
    plain = model.make_prefill_step(cfg, s_max=server.s_max)
    if graphed is None:
        graphed = plain
    else:
        graphed.capture(server.params, b)
    fns = {"eager": lambda: plain(server.params, b),
           "graphed": lambda: graphed(server.params, b)}
    first = {name: fn()[0].clone() for name, fn in fns.items()}
    sync()
    if not torch.equal(first["eager"], first["graphed"]):
        raise AssertionError(f"{cfg.name}: the graphed prefill's logits at "
                             f"{(batch, width)} differ from the eager one's")
    samples = {name: [] for name in fns}
    round_medians = {name: [] for name in fns}
    for r in range(rounds):
        for name in (fns if r % 2 == 0 else reversed(fns)):
            got = []
            call = timed(fns[name], got, cuda)
            for _ in range(calls):
                call()
            samples[name] += got
            round_medians[name].append(float(np.median(got, axis=0)[0]) * 1e3)
    out = {"batch": batch, "width": width, "rounds": rounds, "calls": calls,
           "logits_equal": True}
    for name, fn in fns.items():
        wall = summary([w * 1e3 for w, _ in samples[name]])
        meds = round_medians[name]
        rec = {"wall_ms": wall,
               "enqueue_ms": summary([e * 1e3 for _, e in samples[name]]),
               "round_medians_ms": meds,
               "round_max_over_min": max(meds) / min(meds)}
        if cuda:
            device_ms = []
            traced(fn, device_ms)()
            rec["traced_device_ms"] = device_ms[0]
            rec["host_share"] = 1 - device_ms[0] / wall["median"]
        out[name] = rec
        log(f"{cfg.name} prefill ({batch}, {width}) {name}: wall n "
            f"{wall['n']} median {wall['median']:.3f} ms, IQR/median "
            f"{wall['iqr_over_median']:.4f}; round medians max/min "
            f"{rec['round_max_over_min']:.4f}; enqueue median "
            f"{rec['enqueue_ms']['median']:.3f} ms"
            + (f"; traced device {rec['traced_device_ms']:.3f} ms, host "
               f"share {100 * rec['host_share']:.1f}%" if cuda else ""))
    return out


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
    a counting wrapper around ``ops.attention``, which also keeps each
    call for ``replay_flash``: the prefill's flash time."""
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
    by_causal, real, calls = {True: 0, False: 0}, ops.attention, []

    def counting(q, k, v, **kw):
        by_causal[kw.get("causal", True)] += 1
        calls.append((q, k, v, kw))
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
    check_flash_counts(counts, flash_per_prefill, 1, cfg.name, cfg.hd)
    if int(cache.cur_pos) != prompt + cfg.num_prefix_tokens + steps:
        raise AssertionError(f"{cfg.name}: cache at {int(cache.cur_pos)}")
    flash = replay_flash(calls[:counts["flash"]])
    out = {"batch": batch, "prompt": prompt, "frames": frames,
           "prefix": cfg.num_prefix_tokens, "layers": cfg.n_layers,
           "flash_launches": counts["flash"], "flash": flash,
           "flash_by_causal": {str(k): v for k, v in by_causal.items()},
           "ttft_ms": ttft * 1e3, "decode_steps": steps,
           "decode_step_ms_mean": sum(secs) / max(len(secs), 1) * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"{cfg.name} ({cfg.n_layers} layers"
        f"{f' + {sum(s.n for s in cfg.enc_segments)} encoder' if cfg.enc_segments else ''}"
        f") batch {batch}: {frames or cfg.num_prefix_tokens or 0} "
        f"{'frames' if frames else 'prefix'} + {prompt} tokens; prefill "
        f"{out['ttft_ms']:.1f} ms, flash launches {counts['flash']} "
        f"(causal {by_causal[True]}, non-causal {by_causal[False]}; "
        f"{flash['sum_us']:.1f} µs of flash a prefill: "
        + ", ".join(f"{c['launches']} x {c['us']:.2f} µs at q {c['q']}"
                    f"{'' if c['causal'] else ' non-causal'}"
                    for c in flash["cases"]) + "); "
        f"{steps} decode steps, {out['decode_step_ms_mean']:.3f} ms mean; "
        f"peak memory {out['peak_bytes'] / 2**30:.2f} GiB; logits finite")
    return params, out


def replay_flash(calls, iters=20):
    """Each distinct flash call of one prefill (``calls``: q, k, v and the
    keyword arguments, as the model made them) timed again on its own
    inputs, back to back with CUDA events (``kernel_bench.cuda_us``), and
    the prefill's flash time: the sum of launches x µs."""
    from repro_torch.kernels import ops
    groups: dict = {}
    for q, k, v, kw in calls:
        key = (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
               tuple(sorted(kw.items())))
        groups.setdefault(key, [q, k, v, kw, 0])[4] += 1
    cases = []
    for q, k, v, kw, n in groups.values():
        us = kb.cuda_us(lambda: ops.attention(q, k, v, **kw), iters)
        cases.append({"q": list(q.shape), "kv": list(k.shape),
                      "causal": kw.get("causal", True),
                      "window": kw.get("window"), "softcap": kw.get("softcap"),
                      "launches": n, "us": us})
    return {"cases": cases, "sum_us": sum(c["launches"] * c["us"]
                                          for c in cases)}


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


def other_families(dev, detail, sync, account):
    """Phases 13-16, each timed by ``account``.  Returns the main path's
    flash launches and its flash timings for the ``kernels`` line."""
    import gc

    import torch
    from repro_torch.configs import get_config
    with account.phase("13", "the families at cut depth, card against CPU"):
        detail["families_card_vs_cpu"] = families_card_vs_cpu(dev)

    with account.phase("14", "granite-moe-3b-a800m through Server"):
        granite = get_config(MAIN_ARCH)
        server, detail["granite_serve"], prompts = serve_counted(
            granite, dev, SERVE_REQUESTS, SERVE_LENS, SERVE_MAX_NEW,
            SERVE_MAX_BATCH, granite.n_layers, sync)
        main_launches = detail["granite_serve"]["flash_launches"]
        detail["granite_graph_fault"] = graph_against_plain(
            granite, server, prompts, SERVE_MAX_NEW, sync,
            fault_at=GRAPH_FAULT_STEP)
        detail["granite_prefill_spread"] = prefill_spread(
            granite, server, PATH_B, PATH_S, PREFILL_SPREAD_ROUNDS,
            PREFILL_SPREAD_CALLS, sync)
        detail["granite_prefill_widths"] = prefill_widths_memory(
            granite, server, PATH_B, PREFILL_MORE_WIDTHS, sync)
        detail["granite_profile"] = profile_serving(granite, server.params,
                                                    dev, PATH_B, PATH_S)
        detail["granite_flash"] = flash_timings(dev, granite)
        del server
        torch.cuda.empty_cache()

    with account.phase("15", "the other families at full width"):
        for arch, n, lens, max_new, per_prefill in FAMILY_SERVE:
            cfg = get_config(arch)
            server, rec, _ = serve_counted(cfg, dev, n, lens, max_new,
                                           SERVE_MAX_BATCH, per_prefill, sync)
            detail[f"serve_{arch}"] = rec
            # the eager profile without the server's graph pools (falcon-
            # mamba's prefill pool alone takes ~36 GiB)
            params = server.params
            del server
            gc.collect()
            torch.cuda.empty_cache()
            detail[f"profile_{arch}"] = profile_serving(cfg, params, dev,
                                                        PATH_B, lens[1])
            if per_prefill:
                detail[f"flash_{arch}"] = flash_timings(dev, cfg, PATH_B,
                                                        lens[1])
            del params
            torch.cuda.empty_cache()
        for arch, batch, prompt, steps, frames, layers, per_prefill in \
                FAMILY_STEPS:
            cfg = get_config(arch)
            if layers is not None:
                cfg = cut(cfg, layers)
            params, detail[f"steps_{arch}"] = step_path(
                cfg, dev, batch, prompt, steps, frames, per_prefill, sync)
            del params
            torch.cuda.empty_cache()

    with account.phase("16", "the families' training steps, card against "
                       "CPU"):
        detail["families_train"] = families_train(dev)
    return main_launches, detail["granite_flash"]


# ---------------------------------------------------------------------------
# Launch and sharding, and the benchmark harness (phases 17-20)
# ---------------------------------------------------------------------------

SHARD_BATCH, SHARD_PROMPT, SHARD_STEPS = 4, 2048, 32
#: phase 17's graphed servers serve a third batch at this new prompt width
#: (the prompts' last tokens), and time this many calls of each graph
SHARD_NEW_WIDTH, SHARD_TIMED_CALLS = 1536, 8
#: phase 17's sharded T3 run: its steps, a checkpoint every
#: ``SHARD_T3_CKPT_EVERY`` (the resumed run starts from the first); its
#: losses within ``LOOP_RTOL`` of phase 12's at the same steps
#: (``tests/test_torch_train_loop.py``'s limit)
SHARD_T3_STEPS, SHARD_T3_CKPT_EVERY, LOOP_RTOL = 20, 10, 1e-3
#: phase 18's dry-run processes: (arch, shape or None for every shape);
#: gemma2-27b's batch-1 FSDP cell and falcon-mamba-7b's prefill show the
#: weights kept split (falcon-mamba's train_4k takes longer than the
#: whole run on the host)
DRYRUN_RUNS = (("gemma3-1b", None), ("granite-moe-3b-a800m", None),
               ("gemma2-27b", "long_500k"), ("falcon-mamba-7b", "prefill_32k"))
#: each background job's limit, counted from its start
JOB_TIMEOUT_S = 900
DRYRUN_REFERENCE = ROOT / "tests" / "data" / "dryrun_reference_pod16x16.json"
CARD_EXAMPLES = ("serve_lm.py", "schedule_and_run_cnn.py")
BENCH_SUITES = ("fig2", "fig3", "table1", "fig4", "yolo", "kernels")
#: the beyond-paper suites, at ``--frames 16`` as CI's smoke step runs the
#: reference's
BENCH_SMOKE_SUITES = ("quality", "elastic", "multi_tenant", "replication",
                      "serving", "sensitivity", "partition")
SIM_BASELINE = ROOT / "BENCH_sim_torch.json"
GLOO_WORKERS = ROOT / "tests" / "test_torch_gloo_workers.py"


def start_dryruns():
    """Phase 18's dry runs, started before phase 1 so that they run on the
    host's cores while the card phases run: one ``Job`` per entry of
    ``DRYRUN_RUNS``, each on a fake process group (the fake group never
    shares a process with the card's).  Returns {name: job}."""
    jobs = {}
    for arch, shape in DRYRUN_RUNS:
        name = arch if shape is None else f"{arch}__{shape}"
        jobs[name] = Job(
            f"dry run {name}",
            [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
              arch, "--force"] + ([] if shape is None else ["--shape", shape])],
            OUT_DIR / f"dryrun_{name}.log", JOB_TIMEOUT_S)
    return jobs


def start_gloo():
    """Phase 21's gloo ranks (``tests/test_torch_gloo_workers.py``, which
    imports no jax), started before phase 1 as the dry runs are: three sets
    of CPU ranks, one after another, under this machine's PyTorch."""
    import shutil
    out_dir = OUT_DIR / "gloo"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    return Job("gloo ranks", [[sys.executable, str(GLOO_WORKERS),
                               str(out_dir)]], OUT_DIR / "gloo.log",
               JOB_TIMEOUT_S)


def baseline_digests() -> dict:
    """sha256 of the port's ``BENCH_sim_torch.json`` and the reference's
    ``BENCH_sim.json``, by file name."""
    import hashlib
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (SIM_BASELINE, ROOT / "BENCH_sim.json")}


def start_host_suites():
    """Phase 20's host half, started before phase 1 as the dry runs are,
    off the card phases' critical path: the beyond-paper suites at
    ``--frames 16``, then the simulator's perf gate, ``python -m
    benchmarks_torch.sim_speed --frames 64 --check BENCH_sim_torch.json``
    (its ratios are of runs alternated in one process, so a loaded host
    slows both sides of each).  One job runs them in turn: both write the
    suites' JSON.  Returns the job and ``baseline_digests()`` taken before
    it starts."""
    before = baseline_digests()
    return Job("host suites",
               [[sys.executable, "-m", "benchmarks_torch.run", "--frames",
                 "16", *BENCH_SMOKE_SUITES],
                [sys.executable, "-m", "benchmarks_torch.sim_speed",
                 "--frames", "64", "--check", SIM_BASELINE.name]],
               OUT_DIR / "host_suites.log", JOB_TIMEOUT_S), before


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


def sharded_serving(dev, sync, t3):
    """Phase 17: granite-moe-3b-a800m at full width and depth (phase 14's
    weights, seed 0, and its first 4 prompts, left-padded to 2,048) through
    ``make_prefill_step``/``make_decode_step``, first unsharded, then on a
    real one-rank NCCL process group: ``make_host_mesh()``, parameters,
    batch and cache placed by ``sharding`` as DTensors, the steps under
    ``activation_mesh``.  One warm-up prefill, then with the counts set to
    0 the prefill (32 tensor-core flash launches, through ``local_map``)
    and 32 greedy decode steps, each fed the sharded run's own token; the
    tokens must equal the unsharded run's.  Then, on the same mesh, the
    graphed ``Server`` on the whole and on the DTensor parameters
    (``graphed_servers``) and T3 through ``train(..., mesh=)`` held to
    phase 12's run ``t3`` (``sharded_t3``)."""
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
        del logits, cache, dbatch
        torch.cuda.empty_cache()
        graphed = graphed_servers(cfg, params, dparams, mesh, toks, sync)
        del dparams
        torch.cuda.empty_cache()
        t3_mesh = sharded_t3(dev, mesh, t3, sync)
    finally:
        dist.destroy_process_group()
    check_flash_counts(counts, cfg.n_layers, 1, f"sharded {cfg.name}", cfg.hd)
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
           "decode_step_ms_max": max(secs) * 1e3, "peak_bytes": peak,
           "graphed": graphed, "t3": t3_mesh}
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


def graph_timing(fn, n, sync):
    """``n`` calls of ``fn`` timed by ``benchmarks_torch.spread``'s
    ``timed`` (wall ending in a synchronise) and one traced by its
    ``traced`` (the device time of its kernels and copies): the median
    wall, the traced device ms and the host share, 1 - traced / median
    wall, as phase 22 reads them; and the launches and flash launches of
    one more call by ``torch.profiler`` (``prefill_trace``)."""
    from benchmarks_torch.spread import summary, timed, traced
    walls, device_ms = [], []
    call = timed(fn, walls, True)
    for _ in range(n):
        call()
    traced(fn, device_ms)()
    sync()
    wall = summary([w * 1e3 for w, _ in walls])["median"]
    trace = prefill_trace(fn)
    return {"wall_ms_median": wall, "traced_device_ms": device_ms[0],
            "host_share": 1 - device_ms[0] / wall,
            "launches": trace["launches"], "flash_by_trace": trace["flash"]}


def locals_of(tree) -> list:
    """Each leaf of ``tree`` as the tensor this rank holds (a DTensor's
    local shard)."""
    from repro_torch.models.lm import sharding
    from repro_torch.tree import tree_leaves
    return [sharding.local_tensor(t) for t in tree_leaves(tree)]


def graphed_server_run(cfg, params, toks, label, sync):
    """Phase 17: ``Server`` on ``params`` (whole, or DTensors on the
    one-rank mesh; both must take the graphed steps) with phase 17's
    prompts: a batch at their width (a capture), the same batch again (a
    replay) and a batch of their last ``SHARD_NEW_WIDTH`` tokens (a
    capture), ``SHARD_STEPS`` new tokens each, the counts set to 0 before
    each batch (32 flash launches a prefill, the repeated width's from its
    replay); then the repeated width's prefill graph and the decode graph
    timed and traced (``graph_timing``).  Returns the server, its tokens a
    batch and the record."""
    import statistics
    import torch
    from repro_torch.runtime.serve_loop import Request, Server
    server = Server(cfg, params, max_batch=SHARD_BATCH,
                    s_max=SHARD_PROMPT + SHARD_STEPS)
    if server.prefill_graph is None or server.graph is None:
        raise AssertionError(f"{label}: Server on the card has no graphs")
    rec = timed_steps(server, sync)
    tokens = []
    for b in (toks, toks, toks[:, -SHARD_NEW_WIDTH:]):
        reqs = [Request(i, row, max_new=SHARD_STEPS)
                for i, row in enumerate(b.cpu())]
        zero_counts()
        server.serve(reqs)
        sync()
        check_flash_counts(read_counts(), cfg.n_layers, 1, label, cfg.hd)
        tokens.append([r.out_tokens for r in reqs])
    ttft = [1e3 * s for s, _ in rec["prefill"]]
    batch = {"tokens": server._pad_prompts(
        [Request(i, row) for i, row in enumerate(toks.cpu())])}
    prefill = server.prefill_graph
    out = {"prefill_graphs": prefill_graphs(server),
           "decode_graphs": len(server.graph.graphs),
           "flash_a_prefill": cfg.n_layers,
           "ttft_ms": {"new_width": ttft[0], "repeated_width": ttft[1],
                       "second_new_width": ttft[2]},
           "decode_step_ms_median": 1e3 * statistics.median(
               s for s, _ in rec["decode"]),
           "capture_s": {"prefill": list(prefill.capture_seconds),
                         "decode": list(server.graph.capture_seconds)},
           "prefill": graph_timing(lambda: prefill(server.params, batch),
                                   SHARD_TIMED_CALLS, sync)}
    logits, cache = prefill(server.params, batch)
    state = {"tok": torch.argmax(logits[:, -1:], dim=-1), "cache": cache}

    def step():
        logits, state["cache"] = server.graph(server.params, state["tok"],
                                              state["cache"])
        return logits
    out["decode"] = graph_timing(step, SHARD_TIMED_CALLS, sync)
    if out["prefill"]["flash_by_trace"] != cfg.n_layers:
        raise AssertionError(f"{label}: a prefill replay's trace shows "
                             f"{out['prefill']['flash_by_trace']} flash "
                             f"launches, want {cfg.n_layers}")
    if out["prefill_graphs"] != 2 or out["decode_graphs"] != 1:
        raise AssertionError(f"{label}: {out['prefill_graphs']} prefill and "
                             f"{out['decode_graphs']} decode graphs, want 2 "
                             f"and 1")
    p, d = out["prefill"], out["decode"]
    log(f"{label}: prefill graphs {out['prefill_graphs']}, decode graphs "
        f"{out['decode_graphs']}, {cfg.n_layers} flash launches a prefill "
        f"(the repeated width's from its replay); TTFT new width "
        f"{ttft[0]:.1f} ms (its capture included), repeated {ttft[1]:.1f} "
        f"ms, new width {SHARD_NEW_WIDTH} {ttft[2]:.1f} ms; decode step "
        f"median {out['decode_step_ms_median']:.3f} ms; {SHARD_TIMED_CALLS} "
        f"prefill replays median {p['wall_ms_median']:.3f} ms, traced "
        f"{p['traced_device_ms']:.3f} ms, host share "
        f"{100 * p['host_share']:.1f}%, {p['launches']} launches "
        f"({p['flash_by_trace']} flash by the trace); decode "
        f"replays median {d['wall_ms_median']:.3f} ms, traced "
        f"{d['traced_device_ms']:.3f} ms, host share "
        f"{100 * d['host_share']:.1f}%, {d['launches']} launches")
    return server, tokens, out


def graphed_against_eager(cfg, server, mesh, toks, sync):
    """The sharded server's prefill graph (a replay) and decode graph
    against the eager sharded steps on the same inputs, under
    ``activation_mesh``: logits and caches ``torch.equal`` shard by shard.
    Returns the unequal outputs of each (empty lists when equal)."""
    import torch
    from repro_torch.models.lm import model, sharding
    from repro_torch.runtime.serve_loop import Request
    batch = {"tokens": server._pad_prompts(
        [Request(i, row) for i, row in enumerate(toks.cpu())])}
    plain_prefill = model.make_prefill_step(cfg, server.s_max)
    plain_decode = model.make_decode_step(cfg)
    got = locals_of(server.prefill_graph(server.params, batch))
    with sharding.activation_mesh(mesh):
        logits, cache = plain_prefill(server.params, batch)
    sync()
    pre = unequal_outputs(got, locals_of((logits, cache)))
    tok = torch.argmax(logits[:, -1:], dim=-1)
    got = locals_of(server.graph(server.params, tok, cache))
    with sharding.activation_mesh(mesh):
        want = locals_of(plain_decode(server.params, tok, cache))
    sync()
    return pre, unequal_outputs(got, want)


def graphed_servers(cfg, params, dparams, mesh, toks, sync):
    """Phase 17's graphed servers on the one-rank NCCL mesh: the whole
    parameters' (dropped, its pool with it, before the next captures),
    then the DTensor parameters' (``graphed_server_run``), whose tokens
    must equal the first's batch for batch, and whose graphed prefill and
    decode step must be ``torch.equal`` to the eager sharded steps on the
    same inputs (``graphed_against_eager``)."""
    import gc
    import torch
    server, want, whole = graphed_server_run(
        cfg, params, toks, f"graphed {cfg.name}, whole parameters", sync)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    server, got, sharded = graphed_server_run(
        cfg, dparams, toks, f"graphed {cfg.name}, DTensor parameters on the "
        f"one-rank NCCL mesh", sync)
    pre, dec = graphed_against_eager(cfg, server, mesh, toks, sync)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    same = got == want
    log(f"graphed {cfg.name} sharded against whole: tokens equal {same} "
        f"(3 batches of {SHARD_BATCH}); sharded graphed against eager "
        f"sharded: prefill {'torch.equal' if not pre else pre}, decode step "
        f"{'torch.equal' if not dec else dec}; sharded / whole: prefill "
        f"replay {sharded['prefill']['wall_ms_median']:.3f} / "
        f"{whole['prefill']['wall_ms_median']:.3f} ms (traced "
        f"{sharded['prefill']['traced_device_ms']:.3f} / "
        f"{whole['prefill']['traced_device_ms']:.3f}), decode replay "
        f"{sharded['decode']['wall_ms_median']:.3f} / "
        f"{whole['decode']['wall_ms_median']:.3f} ms (traced "
        f"{sharded['decode']['traced_device_ms']:.3f} / "
        f"{whole['decode']['traced_device_ms']:.3f}), TTFT at a new width "
        f"{sharded['ttft_ms']['new_width']:.1f} / "
        f"{whole['ttft_ms']['new_width']:.1f} ms")
    if not same:
        raise AssertionError(f"graphed {cfg.name}: the sharded server's "
                             f"tokens differ from the whole one's")
    if pre or dec:
        raise AssertionError(f"graphed {cfg.name}: sharded graphs differ from "
                             f"the eager sharded steps: prefill {pre}, "
                             f"decode {dec}")
    return {"whole": whole, "sharded": sharded, "tokens_equal": same,
            "graphed_equal_eager": True}


def sharded_t3(dev, mesh, t3, sync):
    """Phase 17: T3 (phase 12's model, shapes and schedule) through
    ``train(..., mesh=mesh)`` on the one-rank NCCL mesh, in a temporary
    directory: ``SHARD_T3_STEPS`` steps with a checkpoint every
    ``SHARD_T3_CKPT_EVERY``, then a run to ``SHARD_T3_CKPT_EVERY`` and one
    resumed from it to ``SHARD_T3_STEPS``.  Each run must capture one
    graph and report no retry or rollback; the losses must lie within
    ``LOOP_RTOL`` of phase 12's at the same steps, and the resumed run's
    within it of the full run's."""
    import statistics
    import tempfile
    from repro_torch.configs import ShapeSpec
    from repro_torch.runtime.train_loop import train
    cfg = stablelm_100m()
    shape = ShapeSpec("example", T3_SEQ, T3_BATCH, "train")
    opt = t3_schedule()
    stamps = []
    with tempfile.TemporaryDirectory() as tmp:
        def run(total, sub, hook=None):
            rep = train(cfg, shape, t3_loop(total, SHARD_T3_CKPT_EVERY, opt,
                                            Path(tmp), sub),
                        fault_hook=hook, mesh=mesh, device=dev)
            if len(rep.capture_seconds) != 1 or rep.retries or rep.rollbacks:
                raise AssertionError(
                    f"sharded T3 {sub} to {total}: {len(rep.capture_seconds)} "
                    f"graphs, {rep.retries} retries, {rep.rollbacks} "
                    f"rollbacks")
            return rep
        full = run(SHARD_T3_STEPS, "full",
                   lambda step: stamps.append(time.perf_counter()))
        first = run(SHARD_T3_CKPT_EVERY, "pair")
        second = run(SHARD_T3_STEPS, "pair")
    if second.resumed_from != SHARD_T3_CKPT_EVERY:
        raise AssertionError(f"sharded T3: resumed from {second.resumed_from}")

    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want, strict=True))
    to_phase12 = rel(full.losses, t3["losses"][:SHARD_T3_STEPS])
    resumed = rel(first.losses + second.losses, full.losses)
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    out = {"steps": full.steps_run, "losses": full.losses,
           "max_rel_to_phase12": to_phase12, "resume_max_rel": resumed,
           "resumed_from": second.resumed_from,
           "capture_s": [r.capture_seconds[0] for r in (full, first, second)],
           "step_s_median": statistics.median(gaps),
           "phase12_step_s_median": t3["step_s_median"]}
    log(f"sharded T3 {cfg.name} through train(mesh=) on the one-rank NCCL "
        f"mesh: {full.steps_run} steps, one graph a run (captures "
        + ", ".join(f"{c:.3f}" for c in out["capture_s"]) + " s); losses "
        f"against phase 12's max rel d {to_phase12:.3e} (limit {LOOP_RTOL}); "
        f"resumed from {second.resumed_from}: max rel d {resumed:.3e}; "
        f"graphed step {1e3 * out['step_s_median']:.2f} ms median (phase 12: "
        f"{1e3 * t3['step_s_median']:.2f} ms)")
    if to_phase12 > LOOP_RTOL or resumed > LOOP_RTOL:
        raise AssertionError(f"sharded T3: losses {to_phase12:.3e} from phase "
                             f"12's, {resumed:.3e} from the uncut run's")
    return out


def dryrun_cells(jobs, account):
    """Phase 18: join the dry runs of ``start_dryruns``, then print each
    cell's status, per-device peak, FLOPs and collective bytes, and the
    roofline's row for it.  Every supported cell must end ``ok``."""
    from repro_torch.configs import SHAPES, get_config, shape_supported
    from repro_torch.launch import dryrun, roofline
    for job in jobs.values():
        job.join(account)
    log("dry run on the fake 16x16 mesh (256 ranks, CPU; model estimates "
        "under H100 constants, not measurements), each figure beside the "
        "reference's dry run of the cell [ref] and port / ref:")
    refs = json.loads(DRYRUN_REFERENCE.read_text())["cells"]
    cells = {}
    for arch, only in DRYRUN_RUNS:
        for shape in SHAPES if only is None else (only,):
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
                "MiB port [reference; with its tuple collectives; from a "
                "one-layer base] "
                + (", ".join(f"{k} {g / 2**20:.1f} [{w / 2**20:.1f}; "
                             f"{t / 2**20:.1f}; {b / 2**20:.1f}] "
                             + (f"{g / w:.2f}x" if w else "-")
                             for k, (g, w, t, b) in vs["collectives"].items())
                   or "none")
                + f"; total {vs['total'][0] / 2**20:.1f} against the "
                f"one-layer base's {vs['total'][3] / 2**20:.1f} MiB"
                + (f" ({vs['total'][0] / vs['total'][3]:.2f}x)"
                   if vs["total"][3] else "")
                + f"; embedding lookup {art['lookups'] or 'not fsdp'}")
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


#: the fields every port case of the kernel bench must have on the card
PORT_FIELDS = ("kernel_us", "cold_us", "plain_us", "library_us", "library",
               "bound_us", "bound", "max_abs_err")
#: and the INT8 port cases besides (``raw_instance``: the instance of the
#: timed raw launch)
INT8_FIELDS = ("graph_us", "wrapper_us", "raw_instance")


def check_kernel_bench(out):
    """The kernel bench's record must hold every reference case in order,
    then the port cases of ``kernel_bench.served_cases`` and the two path
    sums; every case run on the card (a kernel time), launched (a nonzero
    count) and equal to its plain version; every flash launch of the
    reference's cases on the instance the dispatch rule names for its f32
    inputs, every launch of a port case on the instance its rule names
    (``kernel_bench.rule_instance``), the INT8 ones' timed raw launch too,
    and each port case with its cold, plain, library and bound columns (the
    INT8 ones with their graph and wrapper times)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    port = kb.served_cases()
    sums = tuple(f"port.path.{p}" for p in kb.PATH_SUMS)
    want = BENCH_CASES + tuple(c.key for c in port) + sums
    if tuple(out) != want:
        raise AssertionError(f"kernel bench: cases {list(out)}, want "
                             f"{list(want)}")
    for name in want[:-len(sums)]:
        rec = out[name]
        if "kernel_us" not in rec or not rec.get("matches_plain") \
                or rec.get("launches", 0) < 1:
            raise AssertionError(f"kernel bench {name}: {rec}")
        if name.startswith("flash."):
            inst = {fa.instance(torch.float32, int(name.split("x")[-1])):
                    rec["launches"]}
            if rec.get("instances") != inst:
                raise AssertionError(f"kernel bench {name}: launches by "
                                     f"instance {rec.get('instances')}, want "
                                     f"{inst}")
    for case in port:
        rec = out[case.key]
        inst_name = kb.rule_instance(case)
        inst = {inst_name: rec["launches"]}
        if rec.get("instances") != inst:
            raise AssertionError(f"kernel bench {case.key}: launches by "
                                 f"instance {rec.get('instances')}, want {inst}")
        fields = PORT_FIELDS + (INT8_FIELDS if case.kind != "flash_bf16" else ())
        missing = [f for f in fields if f not in rec]
        if missing:
            raise AssertionError(f"kernel bench {case.key}: no {missing}")
        if case.kind != "flash_bf16" and rec["raw_instance"] != inst_name:
            raise AssertionError(f"kernel bench {case.key}: its timed raw "
                                 f"launch on {rec['raw_instance']}, the rule "
                                 f"names {inst_name}")
    for name in sums:
        missing = [f for f in ("kernel_us", "cold_us", "bound_us")
                   if out[name].get(f) is None]
        if missing:
            raise AssertionError(f"kernel bench {name}: no {missing}")
    return out


def bench_on_card(card, phase_sums):
    """Phase 20: the port's benchmark harness as a user runs it, in a
    subprocess: the paper's suites on the host and the kernel bench on the
    card.  It must exit 0, and every kernel-bench case must have launched
    its kernel and equal its plain version.  The two path sums are logged
    beside ``phase_sums``: by path, (source, {column: µs}), the same path's
    sums from phases 5 and 14 of this run (the same ``time_case`` in this
    process), a request or a prefill."""
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
        if (line.startswith("CSV,") and not line.startswith("CSV,port.")) \
                or "paper" in line:
            log(f"  {line}")
    art = ROOT / "artifacts" / "bench_torch"
    bench = check_kernel_bench(json.loads((art / "kernel_bench.json")
                                          .read_text()))
    log(f"kernel bench on {card} (CUDA events, launches back to back, "
        f"warm; µs):")
    log("  case                     kernel      plain    library      bound"
        "  bound by            launches  max |d|")
    for name in BENCH_CASES:
        rec = bench[name]
        by_inst = f" {rec['instances']}" if "instances" in rec else ""
        log(f"  {name:<22s} {rec['kernel_us']:10.2f} {rec['plain_us']:10.2f} "
            f"{rec['library_us']:10.2f} {rec['bound_us']:10.2f}  "
            f"{rec['bound']} ({rec['bound_constant']}){'':<3s} "
            f"{rec['launches']:8d}  {rec['max_abs_err']:.2e}  "
            f"[{rec['library']}]{by_inst}")

    log(f"kernel bench, the served kernels on {card} (µs; cold: each launch "
        f"alone after a {kb.FLUSH_BYTES >> 20} MiB write; graph: replayed "
        f"from a CUDA graph; wrapper: through imc_conv2d/imc_mvm):")
    compared = {}
    for path in kb.PATH_SUMS:
        cases = [c for c in kb.served_cases() if c.path == path]
        total = bench[f"port.path.{path}"]
        log_port_cases(cases, bench, total, f"port.path.{path}")
        source, phase = phase_sums[path]
        compared[path] = {f: {"bench_us": total[f], "phase_us": phase[f],
                              "ratio": total[f] / phase[f]}
                          for f in kb.SUM_FIELDS
                          if total.get(f) is not None
                          and phase.get(f) is not None}
        log(f"    beside {source}, the same cases in this process: "
            + ", ".join(f"{f} {c['bench_us']:.2f} against {c['phase_us']:.2f}"
                        f" ({c['ratio']:.3f}x)"
                        for f, c in compared[path].items()))
    for case in kb.served_cases():
        if case.path not in kb.PATH_SUMS:
            rec = bench[case.key]
            log(f"  {kb.port_row(case.key, rec)}  x{case.path_launches} "
                f"({case.path}), {rec['bound']}, {rec['instances']}, "
                f"{rec['plan']}, {rec['max_abs_err']:.2e}, "
                f"{rec['library']}")
    suites = {n: json.loads((art / f"{f}.json").read_text()) for n, f in
              (("fig2", "fig2_resnet8"), ("fig3", "fig3_resnet18"),
               ("table1", "table1_utilization"), ("fig4", "fig4_imc_dpu"),
               ("yolo", "yolo_latency"))}
    log(f"benchmarks_torch.run {' '.join(BENCH_SUITES)}: exit 0 in "
        f"{wall:.1f} s (process start and kernel load included)")
    return {"wall_s": wall, "kernel_bench": bench, "suites": suites,
            "path_sums_vs_phases": compared}


def run_logged(cmd, name, timeout=900):
    """``cmd`` from the repo root with ``src/`` on the path; its output
    goes to ``OUT_DIR/<name>.log``.  It must exit 0.  Returns (stdout,
    wall seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    wall = time.perf_counter() - t
    (OUT_DIR / f"{name}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])}: exit {res.returncode}: "
                             f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
    return res.stdout, wall


def host_suites(job, before, account):
    """Phase 20, its host half: join the job of ``start_host_suites``.  Both
    commands must exit 0: the beyond-paper suites, each writing its JSON,
    and the perf gate (each suite's speedup within its slack of the
    committed baseline's, after one re-measure); the committed baseline,
    and the reference's ``BENCH_sim.json``, must be byte for byte as they
    were (``before``, sha256)."""
    job.join(account)
    smoke_wall, gate_wall = job.walls
    out = job.log_path.read_text()
    for line in out.splitlines():
        if line.startswith("CSV,") and not line.startswith("CSV,sim_speed."):
            log(f"  {line}")
    art = ROOT / "artifacts" / "bench_torch"
    missing = [f for f in ("scheduler_quality", "elastic_bench",
                           "multi_tenant", "replication", "serving",
                           "sensitivity", "lm_partition")
               if not (art / f"{f}.json").exists()]
    if missing:
        raise AssertionError(f"benchmarks_torch.run: no artifact {missing}")
    log(f"benchmarks_torch.run --frames 16 {' '.join(BENCH_SMOKE_SUITES)}: "
        f"exit 0 in {smoke_wall:.1f} s on the host ({host_cpu()}), in the "
        f"background")
    after = baseline_digests()
    if after != before:
        raise AssertionError(f"sim_speed --check changed {before} -> {after}")
    gate = out[out.index("== sim_speed"):]
    for line in gate.splitlines():
        if line.startswith(("yolo", "mt ", "event loop", "benchmarks_torch",
                            "  ", "perf gate", "re-measuring")):
            log(f"  {line}")
    sim = json.loads((art / "sim_speed.json").read_text())
    log(f"sim_speed --frames 64 --check {SIM_BASELINE.name}: exit 0 in "
        f"{gate_wall:.1f} s on the host ({host_cpu()}), in the background, "
        f"{sim['check']['regressions']} regressions; both baselines "
        f"unchanged (sha256 {before[SIM_BASELINE.name][:12]}, "
        f"{before['BENCH_sim.json'][:12]})")
    return {"smoke_wall_s": smoke_wall, "sim_speed": sim,
            "sim_speed_wall_s": gate_wall, "host_cpu": host_cpu()}


#: the spread's metrics phase 22 requires, besides the enqueue times, the
#: probes, the card's state and each call's device time and host share
SPREAD_METRICS = ("cnn_frames_per_s", "cnn_latency_ms", "ttft_ms", "decode_ms")
SPREAD_TIMEOUT_S = 300
#: the eager granite decode step's traced device ms, least and most of
#: earlier spread runs on an H100 80GB HBM3 at 700 W (PERF.md, section 7)
EAGER_DECODE_DEVICE_MS = (19.17, 19.27)
#: the eager granite prefill's (4 x 2,048) traced device ms, least and most
#: of the spread runs before its graph (PERF.md, section 7)
EAGER_PREFILL_DEVICE_MS = (140.0, 140.9)


def spread_on_card():
    """Phase 22: ``python -m benchmarks_torch.spread`` (12 interleaved
    rounds of the CNN and granite paths, built as phases 4 and 14 build
    them) in a subprocess: it must exit 0, which it does only with
    granite's tokens equal in every round; its record must hold each of
    ``SPREAD_METRICS``, the enqueue times, the host probes, the card's
    clocks, power and temperature, and each call's device time from the
    traced round with its host share.  Its table is logged."""
    from benchmarks_torch import spread
    out, wall = run_logged([sys.executable, "-m", "benchmarks_torch.spread"],
                           "spread", timeout=SPREAD_TIMEOUT_S)
    for line in out.splitlines():
        log(f"  {line}")
    rec = json.loads((ROOT / "artifacts" / "bench_torch" / "spread.json")
                     .read_text())
    want = SPREAD_METRICS + spread.CARD_METRICS + spread.PROBES
    missing = [m for m in want if m not in rec["metrics"]]
    traced = set(rec.get("traced", ())) == {p for _, p in spread.CALLS}
    if missing or not traced or not rec.get("tokens_equal") \
            or "card" not in rec:
        raise AssertionError(f"spread: no {missing}, no traced round's "
                             f"device times or no card in its record (tokens "
                             f"equal: {rec.get('tokens_equal')})")
    inside = rec["build_s"] + rec["rounds_s"] + rec["traced_s"]
    log(f"benchmarks_torch.spread: exit 0 in {wall:.1f} s, {rec['rounds']} "
        f"rounds: build of both paths and warm-up {rec['build_s']:.1f} s, "
        f"rounds {rec['rounds_s']:.1f} s, traced round {rec['traced_s']:.1f} "
        f"s, the rest (process start, imports, exit) {wall - inside:.1f} s")
    dec = rec["traced"]["decode"]
    got = dec["device_ms"]["median"]
    lo, hi = EAGER_DECODE_DEVICE_MS
    near = 0.95 * lo <= got <= 1.05 * hi
    rec["decode_device_vs_eager"] = got / ((lo + hi) / 2)
    log(f"spread: the traced round's granite decode step, replayed from its "
        f"graph, sums {got:.4g} ms of device time against the eager step's "
        f"{lo}-{hi} ms: {'within' if near else 'NOT within'} 5% (ratio "
        f"{rec['decode_device_vs_eager']:.3f}); host {dec['host_ms']:.4g} ms, "
        f"{100 * dec['host_share']:.1f}% of the wall median "
        f"{dec['wall_ms_median']:.4g} ms")
    pre = rec["traced"]["ttft"]
    lo, hi = EAGER_PREFILL_DEVICE_MS
    log(f"spread: the traced round's granite prefill, replayed from its "
        f"graph, sums {pre['device_ms']['median']:.4g} ms of device time "
        f"against the eager prefill's {lo}-{hi} ms; host "
        f"{pre['host_ms']:.4g} ms, {100 * pre['host_share']:.1f}% of the wall "
        f"median {pre['wall_ms_median']:.4g} ms")
    return rec


def gloo_ranks(job, account):
    """Phase 21: join the gloo ranks of ``start_gloo`` (the 3-rank
    serving and train steps of ``GLOO_ARCHS``, the (2, 2) gradients of
    every ``GRAD_ARCHS`` family, the sequence-split decode and the FSDP
    arch's batch-1 decode, all on this machine's CPU and PyTorch) and hold
    them to ``tests/test_torch_sharding.py``'s limits: ``SHARD_RTOL``
    against the unsharded port, and no weight gathered where the
    reference keeps it split."""
    import importlib.util
    job.join(account)
    spec = importlib.util.spec_from_file_location("gloo_workers",
                                                  GLOO_WORKERS)
    w = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(w)
    r = w.load(OUT_DIR / "gloo")
    tol = w.SHARD_RTOL
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(what)

    for arch in w.GLOO_ARCHS:
        a = r[arch]
        need(a["padded"] and len(a["serve_rel"]) == 5
             and max(a["serve_rel"]) <= tol, f"{arch} serving {a['serve_rel']}")
        need(a["loss_rel"] <= tol and a["param_rel"] <= tol
             and a["cache_placed"], f"{arch} train step {a}")
        need(max(a["train_gathers"], default=0.0)
             < min(a["weight_bytes"].values()),
             f"{arch} train step gathers {a['train_gathers']}")
        log(f"  {arch} on 3 gloo ranks (1, 3): prefill + 4 decode steps max "
            f"rel {max(a['serve_rel']):.2e}, train step loss rel "
            f"{a['loss_rel']:.2e}, params rel {a['param_rel']:.2e}, "
            f"all-gathers {len(a['train_gathers'])} "
            f"({sum(a['train_gathers']):.0f} B)")
    for arch in w.GRAD_ARCHS + (w.EXCHANGE_CASE,):
        a = r["2x2"][arch]
        need(a["loss_rel"] <= tol and a["grad_rel"] <= tol,
             f"{arch} gradients {a}")
        if a["w_in_bytes"]:
            need(max(a["gathers"], default=0.0) < a["w_in_bytes"],
                 f"{arch} gathers {a['gathers']}")
        log(f"  {arch} on 4 gloo ranks (2, 2): loss rel {a['loss_rel']:.2e}, "
            f"worst gradient leaf {a['worst_leaf']} rel {a['grad_rel']:.2e}, "
            f"largest all-gather {max(a['gathers'], default=0.0):.0f} B")
    for case in (w.MOE_FSDP_ARCH, w.EXCHANGE_CASE):
        a = r["2x2"][case]
        need(len(a["serve_rel"]) == 5 and max(a["serve_rel"]) <= tol
             and a["train"]["loss_rel"] <= tol
             and a["train"]["param_rel"] <= tol,
             f"{case} serving and train step {a}")
        log(f"  {case} on 4 gloo ranks (2, 2): prefill + 4 decode steps max "
            f"rel {max(a['serve_rel']):.2e}, train step params rel "
            f"{a['train']['param_rel']:.2e}, experts exchanged with F cut in "
            f"{a['experts_exchanged'] or 'none'}")
    a = r["2x2"][w.EXCHANGE_CASE]
    need(a["experts_exchanged"] == [2],
         f"{w.EXCHANGE_CASE} exchanged no experts")
    need([n for n in a["gathers"] if n >= a["wq_layer_bytes"]] == [],
         f"{w.EXCHANGE_CASE} gathers {a['gathers']}")
    for case in (w.MOE_FSDP_ARCH, w.EXCHANGE_CASE):
        need(r["2x2"][case]["lookups"] == {"exchange": 1},
             f"{case} embedding lookup {r['2x2'][case]['lookups']}")
    for way, a in r["2x2"]["lookup"].items():
        want = "exchange" if way == "rule" else way
        need(a["lookups"] == {want: 1} and a["rows_rel"] <= tol
             and a["grad_rel"] <= tol and a["grad_split"],
             f"fsdp lookup {way}: {a}")
        log(f"  {w.FSDP_ARCH} embedding lookup on 4 gloo ranks (2, 2), "
            f"{way} ({want}): rows rel {a['rows_rel']:.2e}, table gradient "
            f"rel {a['grad_rel']:.2e}, all-gathers {a['gathers']} B")
    log(f"  {w.MOE_FSDP_ARCH} (2, 2) embedding lookup: "
        f"{r['2x2'][w.MOE_FSDP_ARCH]['lookups']}")
    for batch in ("2", "1"):
        a = r["seq"][batch]
        need(a["cache_seq_split"] == a["want_split"]
             and len(a["decode_rel"]) == 4 and max(a["decode_rel"]) <= tol
             and a["max_reduces"] > 0
             and a["gathered"] < a["cache_layer_bytes"],
             f"sequence-split decode batch {batch}: {a}")
    a = r["seq"]["fsdp_1"]
    need(a["wq_d_split"] and len(a["decode_rel"]) == 4
         and max(a["decode_rel"]) <= tol
         and a["gathered"] < a["wq_layer_bytes"], f"fsdp batch 1: {a}")
    b = r["seq"]["fsdp_2"]
    need(len(b["decode_rel"]) == 4 and max(b["decode_rel"]) <= tol
         and b["all_to_alls"] > 0 and b["lookups"] == {"exchange": 5}
         and [n for n in b["gathers"] if n >= b["wq_layer_bytes"]] == [],
         f"fsdp batch 2: {b}")
    log(f"  sequence-split decode (batch 2, 1) max rel "
        f"{max(r['seq']['2']['decode_rel'] + r['seq']['1']['decode_rel']):.2e}"
        f"; {w.FSDP_ARCH} batch-1 decode max rel {max(a['decode_rel']):.2e}, "
        f"gathered {a['gathered']:.0f} B a step (one layer's wq "
        f"{a['wq_layer_bytes']} B); batch-2 decode max rel "
        f"{max(b['decode_rel']):.2e}, {b['all_to_alls']} all-to-alls")
    if bad:
        raise AssertionError(f"gloo ranks outside the tests' limits: {bad}")
    import torch
    log(f"gloo ranks on this machine's CPU (torch {torch.__version__}): "
        f"every case within SHARD_RTOL {tol:g}")
    return r


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    account = Account(STARTED)
    jobs = []
    try:
        dryruns = start_dryruns()
        jobs += dryruns.values()
        gloo = start_gloo()
        jobs.append(gloo)
        host, baselines = start_host_suites()
        jobs.append(host)
        return run_phases(dryruns, gloo, host, baselines, account)
    finally:
        for job in jobs:
            job.stop()


def run_phases(dryruns, gloo, host_job, baselines, account) -> int:
    import torch
    from repro_torch.kernels import _build, conv2d, imc_mvm as mvm_mod, ref
    from repro_torch.kernels.conv2d import imc_conv2d
    from repro_torch.kernels.imc_mvm import imc_mvm
    from repro_torch.models.cnn import graphs, layers, resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    detail: dict = {}

    with account.phase("1", "device and build"):
        card = kb.card_line()
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
        flash_report = ptxas_report(
            Path(f"{libs['flash_attention']}.log").read_text())
        tc_ptxas = {fn: r for fn, r in flash_report.items()
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
        # the other families' hd-256 path instance, cp.async-staged like the
        # one above (16 steps)
        tag = "ILi16ELb1E"
        inst = [r for fn, r in tc_ptxas.items() if tag in fn]
        if len(inst) != 1 or inst[0].get("spill_stores") != 0 \
                or inst[0].get("spill_loads") != 0:
            raise AssertionError(f"ptxas: the other families' flash instance "
                                 f"{tag} spills or is missing: {inst}")
        log("ptxas: the 16-step cp.async flash instance (the other families' "
            "hd-256 paths) does not spill")
        detail["flash_wg"] = wgmma_instances(libs["flash_attention"],
                                             flash_report)
        tc32_ptxas = {fn: r for fn, r in flash_report.items()
                      if "flash_tc32_kernel" in fn}
        if not tc32_ptxas:
            raise AssertionError("ptxas reported no flash f32 tensor-core instance")
        detail["flash_tc32_ptxas"] = tc32_ptxas
        for fn, r in sorted(tc32_ptxas.items()):
            log(f"ptxas flash f32 tensor-core instance {fn}: {r.get('registers')} "
                f"registers, {r.get('spill_stores')} bytes spill stores, "
                f"{r.get('spill_loads')} bytes spill loads")
        # the kernel bench's instance (hd 128) and the widest the instance
        # takes, both cp.async-staged
        for hd in (128, fa.TC32_MAX_HEAD_DIM):
            tag = f"ILi{fa.tc_steps(hd)}ELb1E"
            inst = [r for fn, r in tc32_ptxas.items() if tag in fn]
            if len(inst) != 1 or inst[0].get("spill_stores") != 0 \
                    or inst[0].get("spill_loads") != 0:
                raise AssertionError(f"ptxas: the f32 tensor-core flash instance "
                                     f"at hd {hd} ({tag}) spills or is missing: "
                                     f"{inst}")
            log(f"ptxas: the f32 tensor-core flash instance at hd {hd} ({tag}) "
                f"does not spill")
        g18 = graphs.resnet18_graph()
        path_convs = kb.conv_shapes(g18, BATCH)
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

    with account.phase("2", "INT8 kernels against their plain versions"):
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
        for shape in distinct + ragged_convs:
            B, H, W, cin, cout, k, s, padding = shape
            qx, qw = rand_int8((B, H, W, cin)), rand_int8((k, k, cin, cout))
            sw, bias = rand_scales(cout), torch.randn((cout,), generator=gen,
                                                      device=dev)
            sx = torch.full((), 0.04, device=dev)
            pads = layers.conv_pads(H, W, k, s, padding)
            conv_check(qx, qw, sx, sw, bias, s, pads, str(shape), err)
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

        for M, K, N in [(BATCH, 256, 10), (257, 129, 65), (1, 512, 512)]:
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
            log(f"check imc_mvm {(M, K, N)} [{rule}]: torch.equal")

        grad_guard_checks(dev)

    with account.phase("3", "placement"):
        lblp, detail["placement"] = schedule_and_simulate(g18)
        if set(lblp.mapping) != set(g18.nodes):
            raise AssertionError("place: the LBLP mapping does not cover the graph")
        detail["placement"]["yolov8n"] = place_yolov8n()
        detail["elastic"] = elastic_sessions()
        detail["serving"] = serving_plane()
        detail["partition"] = stage_partition()

    with account.phase("4", "the main path, ResNet-18 INT8"):
        zero_counts()
        log(f"resnet18_cifar: executing the graph LBLP placed ({len(g18)} nodes on "
            f"{len(set(lblp.mapping.values()))} PUs of the IMCE model)")
        rec18, served18 = serve_cnn(resnet.RESNET18_CIFAR, g18, REQUESTS,
                                    "resnet18_cifar", dev, BATCH,
                                    torch.cuda.synchronize)
        counts18 = tuple(rec18["launches"])
        if tuple(rec18["conv_by_staging"]) != (19 * REQUESTS, REQUESTS):
            raise AssertionError(f"resnet18_cifar: conv launches by staging "
                                 f"{rec18['conv_by_staging']}; want 19 cp.async "
                                 f"and 1 gather a request")
        detail["e2e"] = rec18
        zero_counts()
        detail["e2e_resnet8"], _ = serve_cnn(
            resnet.RESNET8, graphs.resnet8_graph(), 1, "resnet8", dev, BATCH,
            torch.cuda.synchronize)
        # the card's own count of one replay, and where a request's time goes
        detail["profile"] = profile_cnn(g18, *served18)

    with account.phase("5", "kernel timings at the path's shapes"):
        # the kernel bench's own cases (``kernel_bench.cnn_cases``), run here
        cnn_cases = kb.cnn_cases(g18, BATCH)
        cnn_recs, cnn_total = kb.time_path(
            cnn_cases, dev, torch.Generator(device=dev).manual_seed(5))
        conv_cases = [c for c in cnn_cases if c.kind == "imc_conv2d"]
        fc_case, = [c for c in cnn_cases if c.kind == "imc_mvm"]
        conv_total = kb.path_sum(conv_cases, cnn_recs)
        fc = cnn_recs[fc_case.key]
        log(f"per request of {BATCH} frames ({conv_total['path_launches']} conv "
            f"+ 1 mvm launches; µs; cold: each launch alone after a "
            f"{kb.FLUSH_BYTES >> 20} MiB write; graph: replayed from a CUDA "
            f"graph; wrapper: through imc_conv2d/imc_mvm):")
        log_port_cases(cnn_cases, cnn_recs, cnn_total, "per request")
        log(f"  {kb.port_row('imc_conv2d per request', conv_total)}")
        detail["imc_conv2d"] = {"cases": cnn_recs, "per_request": conv_total,
                                "with_fc": cnn_total}
        detail["imc_mvm"] = fc

    with account.phase("5b", "YOLOv8n at 640x640"):
        log(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
        yolo_params, detail["yolov8n_card_vs_cpu"] = yolo_card_vs_cpu(
            dev, YOLO_HW, YOLO_CHECK_FRAMES)
        yb = yolo_serve(yolo_params, dev, YOLO_HW, YOLO_REQUESTS, YOLO_BATCH,
                        torch.cuda.synchronize)
        yb["served"], yolo_request, yolo_xs = yolo_graphed(
            yolo_params, dev, YOLO_HW, YOLO_REQUESTS, YOLO_BATCH,
            YOLO_SECOND_BATCH, torch.cuda.synchronize)
        yb["spread"] = yolo_spread(yolo_params, yolo_request, yolo_xs,
                                   YOLO_SPREAD_ROUNDS, True)
        yb["profile"] = yolo_profiles(yolo_params, yolo_request, yolo_xs[0])
        yb["card"] = card
        detail["yolov8n_serve"] = yb
        log(f"yolov8n request ({YOLO_BATCH} frames) on {card}: bound "
            f"{yb['bound_ms']:.4f} ms; eager then graphed: median wall "
            + ", ".join(f"{yb['spread'][k]['wall_ms']['median']:.3f}"
                        for k in ("eager", "graphed"))
            + " ms, traced device "
            + ", ".join(f"{yb['spread'][k]['traced_device_ms']:.3f}"
                        for k in ("eager", "graphed"))
            + " ms, launches by trace "
            + ", ".join(str(yb["profile"][k]["launches"])
                        for k in ("eager", "graphed")))
        del yolo_params, yolo_request, yolo_xs
        torch.cuda.empty_cache()

    with account.phase("6", "flash against its plain version"):
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.models.lm import transformer
        log(f"torch.backends.cuda.matmul.allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}")
        gemma = get_config("gemma3-1b")
        local_window = min(gemma.segments[0].window_pattern)
        flash_errs = flash_checks(dev, gemma.hd, local_window)

    with account.phase("7", "gemma3-1b cut depth, card against CPU"):
        period = cut(gemma, len(gemma.segments[0].window_pattern))
        detail["lm_card_vs_cpu"] = lm_card_vs_cpu(period, dev, LM_PROMPT,
                                                  LM_DECODE_STEPS)
        log(f"gemma3-1b {period.n_layers} layers, full width: card vs cpu within "
            f"{detail['lm_card_vs_cpu']['worst_rel']:.3e} of max |logit| (limit "
            f"{LM_LOGIT_TOL}), {detail['lm_card_vs_cpu']['tokens_compared']} "
            f"tokens compared; cpu prefill "
            f"{detail['lm_card_vs_cpu']['cpu_prefill_s']:.1f} s")

    with account.phase("8", "gemma3-1b through Server"):
        server, detail["serve"], _ = serve_counted(
            gemma, dev, SERVE_REQUESTS, SERVE_LENS, SERVE_MAX_NEW, SERVE_MAX_BATCH,
            gemma.n_layers, torch.cuda.synchronize)
        detail["serve"]["prefill_spread"] = prefill_spread(
            gemma, server, PATH_B, PATH_S, PREFILL_SPREAD_ROUNDS,
            PREFILL_SPREAD_CALLS, torch.cuda.synchronize)
        detail["serve"]["prefill_widths"] = prefill_widths_memory(
            gemma, server, PATH_B, PREFILL_MORE_WIDTHS, torch.cuda.synchronize)

    with account.phase("9", "flash timings and the LM profile"):
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
    with account.phase("10", "T1, a gemma3-1b step, card against CPU"):
        two = dataclasses.replace(gemma, segments=(
            Segment("attn", 2, window_pattern=(local_window, GLOBAL_WINDOW)),))
        detail["train_t1"] = train_card_vs_cpu(two, dev, T1_SEQ)
        log(f"train T1: card vs cpu within {detail['train_t1']['loss_rel']:.2e} "
            f"(loss), {detail['train_t1']['grad_norm_rel']:.2e} (grad norm), "
            f"{detail['train_t1']['worst_grad_rel']:.2e} (worst leaf gradient)")

    with account.phase("11", "T2, gemma3-1b training at full depth"):
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

    with account.phase("12", "T3, the training example through train()"):
        zero_counts()
        t3_cfg = stablelm_100m()
        t3_shape = ShapeSpec("example", T3_SEQ, T3_BATCH, "train")
        t3_opt = t3_schedule()
        with tempfile.TemporaryDirectory() as tmp:
            t3 = train_example(t3_cfg, dev, T3_STEPS, T3_BATCH, T3_SEQ,
                               T3_CKPT_EVERY, t3_opt, Path(tmp),
                               torch.cuda.synchronize)
            if len(t3["capture_s"]) != 1:
                raise AssertionError(f"train T3: the 120-step run captured "
                                     f"{len(t3['capture_s'])} graphs, not 1")
            t3["faults"] = train_fault_runs(t3_cfg, dev, t3_shape,
                                            T3_CKPT_EVERY, t3_opt, Path(tmp),
                                            t3["losses"])
            t3["plain_loop"] = train_plain_loop(t3_cfg, dev, t3_shape,
                                                T3_CKPT_EVERY, t3_opt, Path(tmp))
        if flash_attention.launches or imc_conv2d.launches or imc_mvm.launches:
            raise AssertionError("train T3: the training path launched a kernel")
        detail["train_t3"] = t3
        t3["graph"] = gate = train_graph_gate(t3_cfg, dev, t3_shape, t3_opt,
                                              torch.cuda.synchronize)
        torch.cuda.empty_cache()
        # one plain step of the example's model under the profiler
        _, t3_step = train_steps(t3_cfg, dev, t3_shape, t3_cfg.microbatch, 2,
                                 adamw.AdamWConfig(lr=3e-4, warmup_steps=1),
                                 torch.cuda.synchronize)
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
        pl = t3["plain_loop"]
        log(f"train T3 graphed step (card: {card}): {1e3 * t3['step_s_median']:.2f}"
            f" ms median, {1e3 * t3['step_s_mean']:.2f} ms mean through train() "
            f"(checkpoints included); plain step through the same loop "
            f"{1e3 * pl['step_s_median']:.2f} ms median, "
            f"{1e3 * pl['step_s_mean']:.2f} ms mean over {pl['steps']} steps; "
            f"capture {t3['capture_s'][0]:.3f} s (the gate's {gate['capture_s']:.3f} s)")
        log(f"train T3 one replay: {gate['replay_device_ms']:.2f} ms of device "
            f"time in {gate['replay_launches']} launches, {gate['replay_wall_ms']:.2f}"
            f" ms wall under the profiler; {T3_GRAPH_TIMED} graphed calls "
            f"median {gate['step_ms_median']:.2f} ms, host share "
            f"{100 * gate['host_share']:.1f}%; graphed against plain "
            f"{'torch.equal' if gate['deterministic'] else 'within plain-to-plain'}")

    # ---- 13-16. the other LM families --------------------------------------
    del t3
    torch.cuda.empty_cache()
    main_launches, main_flash = other_families(dev, detail,
                                               torch.cuda.synchronize, account)

    # ---- 17-19. launch and sharding ----------------------------------------
    with account.phase("17", "sharded serving and training on a one-rank "
                       "NCCL mesh"):
        torch.cuda.empty_cache()
        detail["sharded_serving"] = sharded_serving(dev, torch.cuda.synchronize,
                                                    detail["train_t3"])
        torch.cuda.empty_cache()
    with account.phase("18", "the dry runs"):
        detail["dryrun"] = dryrun_cells(dryruns, account)
    with account.phase("19", "the examples on the card"):
        detail["examples"] = examples_on_card()

    with account.phase("20", "the benchmark harness"):
        # joined first: the gate's suites write the JSON that the
        # harness's run below writes and reads
        host = host_suites(host_job, baselines, account)
        torch.cuda.empty_cache()
        phase_sums = {
            "resnet18_int8": (f"phase 5 ({cnn_total['path_launches']} launches "
                              f"a request)", cnn_total),
            "granite_prefill": (f"phase 14 ({main_flash['sum_us']['path_launches']}"
                                f" launches a prefill)", main_flash["sum_us"]),
        }
        detail["bench"] = bench_on_card(card, phase_sums)
        detail["bench"].update(host)

    with account.phase("21", "the gloo ranks"):
        detail["gloo"] = gloo_ranks(gloo, account)

    with account.phase("22", "the run-to-run spread"):
        torch.cuda.empty_cache()
        detail["spread"] = spread_on_card()

    detail["card"] = card
    detail["device"] = torch.cuda.get_device_name(0)
    detail["timing"] = account.record()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=2))

    fc_ms = path_ms(kb.path_sum([fc_case], cnn_recs))
    kernels = [
        {"name": "imc_conv2d", "route": "cuda",
         "source": "src/repro_torch/csrc/imc_conv2d.cu",
         "replaces": "src/repro/kernels/conv2d.py:56",
         "launches": counts18[0], "max_abs_err": err["imc_conv2d"],
         **path_ms(conv_total)},
        {"name": "imc_mvm", "route": "cuda",
         "source": "src/repro_torch/csrc/imc_mvm.cu",
         "replaces": "src/repro/kernels/imc_mvm.py:69",
         "launches": counts18[1], "max_abs_err": err["imc_mvm"], **fc_ms},
        # bf16 flash on wgmma: granite-moe's prefills (phase 14)
        {"name": "flash_attention_wgmma", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": main_launches, "max_abs_err": flash_errs[fa.WGMMA],
         **{k: main_flash[k] for k in FLASH_MS}},
        # bf16 flash on mma.sync at hd 288: gemma3-1b's prefills (phase 8)
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:29",
         "launches": detail["serve"]["flash_launches"],
         "max_abs_err": flash_errs[fa.TENSOR_CORE],
         **{k: detail["flash_attention"][k] for k in FLASH_MS}},
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
