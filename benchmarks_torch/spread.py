"""Run-to-run spread of the port's two served paths on the card.

    python -m benchmarks_torch.spread [--rounds R] [--device cuda|cpu]

Builds, once and from fixed seeds, the two paths ``chip_smoke.py`` serves:
ResNet-18-CIFAR INT8 at full width (parameters from seed 0, calibrated on
a batch from seed 1, as phase 4 builds it) and granite-moe-3b-a800m at
full width and depth in bf16 through ``Server`` (parameters from a
generator seeded 0 on the card, as phase 14 builds it), then serves one
untimed round as a warm-up and runs R interleaved rounds.  Each round:

* the CNN: ``requests`` requests of ``frames`` frames as phase 4 serves
  them: through ``executor.GraphedExecute`` on the card (the weights
  programmed once, each request replayed from a CUDA graph), through
  ``executor.execute(..., mode="int8")`` on the CPU;
* granite: one prefill of ``batch`` prompts of ``prompt`` tokens (seeded
  0) and ``decode_steps`` greedy decode steps; the tokens must equal the
  first round's;
* host probes with the card idle: a fixed pure-Python loop (the
  interpreter's speed) and 1,000 enqueues of a one-element CUDA add,
  timed on the host before the synchronise (the launch cost that bounds
  a decode step);
* the card's state: one ``nvidia-smi`` sample of the SM and memory
  clocks, power draw and temperature; the host's 1-minute load average
  and the size of this process's CPU affinity set.

Each CNN request, prefill and decode step is timed on the host clock:
its wall time (ending in a synchronise) and its ``enqueue`` time (until
the call returned, before the synchronise: near the wall time where the
host sets the pace, well below it where the card does).  After the
timed rounds, one traced round runs each call alone under
``torch.profiler`` and sums the durations of the kernels and copies it
ran on the card: its ``device`` time.  The traced round serves the
prompts for ``TRACED_DECODE_STEPS`` decode steps, not all of them: a
step's trace costs over a second of host time, and over 32 traced steps
on an H100 the device time's quartiles lay within 0.1% of its median.  The ``host`` time of a call is
the timed rounds' median wall minus the traced round's median device
time, and the host share that over the wall.  (A CUDA event pair around
a call would not do: it spans the host's gaps between launches too.)

Each metric is reported with n, the median, the quartiles, the IQR over
the median and the highest integer percentile P that has at least 10
samples beyond it (n (100 - P) / 100 >= 10; none below P 50), and across
rounds with the min, max and max/min of the round medians.  The rank
correlation (Spearman, ties averaged, numpy) of each path's round wall
medians with the host probes says whether the host's speed carries the
spread.

On the card (the default) a missing card is an error: nothing falls back
to the CPU.  ``--device cpu`` is a host rehearsal at stand-in sizes
(ResNet-8, 8 frames; granite's smoke config, 2 layers, 2 x 16 tokens, 4
steps): its wall times are the host's; it runs no traced round and
writes no card field.
Writes ``artifacts/bench_torch/spread.json`` and prints a table.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from .common import dump
from .kernel_bench import card_line

ROUNDS = 12
#: decode steps of the traced round (the timed rounds run all of them)
TRACED_DECODE_STEPS = 8
ARCH = "granite-moe-3b-a800m"
PROBE_LOOP = 200_000
PROBE_ENQUEUES = 1000
SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")
SMI_METRICS = ("smi_sm_mhz", "smi_mem_mhz", "smi_power_w", "smi_temp_c")
#: the timed calls of a round and their metric prefixes
CALLS = (("cnn", "cnn"), ("prefill", "ttft"), ("decode", "decode"))
#: their wall metrics, whose round medians are ranked against the probes
WALL_METRICS = ("cnn_latency_ms", "ttft_ms", "decode_ms")
#: the metrics only a card run has (a CPU run writes none of them); the
#: traced round's device and host times are under ``traced``, by prefix
CARD_METRICS = tuple(f"{p}_enqueue_ms" for _, p in CALLS) \
    + ("probe_enqueue_us",) + SMI_METRICS
PROBES = ("probe_python_ms", "probe_enqueue_us")


class Sizes(NamedTuple):
    """What a round serves: the CNN (``resnet18_cifar`` or ``resnet8``),
    its frames a request and requests a round; the LM config, its prompts
    a prefill, tokens a prompt and decode steps a round."""
    cnn: str
    frames: int
    requests: int
    lm: object
    batch: int
    prompt: int
    decode_steps: int


def served_sizes() -> Sizes:
    """The served paths: phase 4's request (256 frames, 8 a round) and a
    4 x 2,048 granite prefill with 32 decode steps (phases 14 and 17)."""
    from repro_torch.configs import get_config
    return Sizes("resnet18_cifar", 256, 8, get_config(ARCH), 4, 2048, 32)


def stand_in_sizes() -> Sizes:
    """Host rehearsal: ResNet-8 and granite's 2-layer smoke config."""
    from repro_torch.configs import get_config
    return Sizes("resnet8", 8, 2, get_config(ARCH).smoke(), 2, 16, 4)


def tail_percentile(n: int):
    """The highest integer percentile P with at least 10 of ``n`` samples
    beyond it, n (100 - P) / 100 >= 10; None where that P is below 50."""
    p = 100 - math.ceil(1000 / n) if n else 0
    return p if p >= 50 else None


def summary(xs) -> dict:
    """n, median, quartiles, IQR / median (None at a median of 0), min,
    max and the tail percentile's value (``tail_percentile``) of the
    samples ``xs``."""
    a = np.asarray(xs, dtype=float)
    q1, med, q3 = np.percentile(a, (25, 50, 75))
    p = tail_percentile(a.size)
    return {"n": int(a.size), "median": float(med), "q1": float(q1),
            "q3": float(q3),
            "iqr_over_median": float((q3 - q1) / med) if med else None,
            "min": float(a.min()), "max": float(a.max()), "tail_percentile": p,
            "tail": None if p is None else float(np.percentile(a, p))}


def ranks(a) -> np.ndarray:
    """Ranks from 0, ties given their mean rank."""
    a = np.asarray(a, dtype=float)
    r = np.empty(a.size)
    r[np.argsort(a, kind="stable")] = np.arange(a.size)
    for v in np.unique(a):
        tie = a == v
        r[tie] = r[tie].mean()
    return r


def spearman(x, y):
    """Spearman's rank correlation of ``x`` and ``y``; None where either
    is constant."""
    rx, ry = ranks(x), ranks(y)
    if rx.std() == 0 or ry.std() == 0:
        return None
    return float(np.corrcoef(rx, ry)[0, 1])


def build_cnn(sizes: Sizes, dev):
    """Phase 4's CNN: parameters from seed 0, calibrated on a batch from a
    generator seeded 1 on ``dev``, which then draws the requests; the
    request as served (``GraphedExecute`` on the card, ``execute`` on the
    CPU) and one warm call, which captures the graph.  Returns (request
    function, requests)."""
    from repro_torch.models import quant
    from repro_torch.models.cnn import executor, graphs, resnet
    cfg, graph = {"resnet18_cifar": (resnet.RESNET18_CIFAR,
                                     graphs.resnet18_graph),
                  "resnet8": (resnet.RESNET8, graphs.resnet8_graph)}[sizes.cnn]
    g = graph()
    params = resnet.init(torch.Generator().manual_seed(0), cfg, device=dev)
    data = torch.Generator(device=dev).manual_seed(1)
    x_cal = torch.randn((sizes.frames, 32, 32, 3), generator=data, device=dev)
    scales = quant.calibrate_resnet(params, x_cal, cfg)
    xs = torch.randn((sizes.requests, sizes.frames, 32, 32, 3), generator=data,
                     device=dev)

    served = executor.int8_request(g, params, scales)

    def request(x):
        return served(params, x)
    request(x_cal)
    return request, xs


def build_lm(sizes: Sizes, dev):
    """Phase 14's server: bf16 parameters from a generator on ``dev``
    seeded 0, ``Server`` with room for the prompts and the decode steps;
    the prompts from numpy's generator seeded 0."""
    from repro_torch.models.lm import transformer
    from repro_torch.runtime.serve_loop import Server
    cfg = sizes.lm
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    server = Server(cfg, params, max_batch=sizes.batch,
                    s_max=sizes.prompt + sizes.decode_steps)
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, sizes.prompt))
               for _ in range(sizes.batch)]
    return server, prompts


def timed(fn, samples, cuda: bool):
    """``fn`` wrapped to append (wall s, enqueue s) of each call to
    ``samples``; on the card it ends in a synchronise."""
    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0, t1 - t0))
        return out
    return call


def traced(fn, samples):
    """``fn`` wrapped to append the device ms of each call to ``samples``:
    the durations of the kernels and copies it ran on the card, summed from
    ``torch.profiler``'s trace of the call alone (the card's activity only:
    tracing the host's ops too costs seconds a call)."""
    from torch.profiler import ProfilerActivity, profile

    def call(*args):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn(*args)
            torch.cuda.synchronize()
        samples.append(sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3)
        return out
    return call


def python_probe_ms() -> float:
    t = time.perf_counter()
    acc = 0
    for i in range(PROBE_LOOP):
        acc += i * i
    return (time.perf_counter() - t) * 1e3


def enqueue_probe_us(dev) -> float:
    """Host µs a launch of a one-element add, over ``PROBE_ENQUEUES``
    enqueues timed before the synchronise, with the card idle."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(PROBE_ENQUEUES):
        x.add_(1)
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / PROBE_ENQUEUES * 1e6


def smi_sample() -> dict:
    line = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return dict(zip(SMI_METRICS, (float(v) for v in line.split(","))))


def serve_round(sizes, request, xs, server, prompts, wrap):
    """One round: the CNN requests, then the prefill and decode steps, each
    call wrapped by ``wrap(fn, samples)`` (``timed`` or ``traced``);
    returns the samples by call and the tokens."""
    from repro_torch.runtime.serve_loop import Request
    raw = {name: [] for name, _ in CALLS}
    cnn = wrap(request, raw["cnn"])
    for x in xs:
        y = cnn(x)
        if not torch.isfinite(y).all():
            raise AssertionError("spread: non-finite CNN logits")
    pre, dec = server.prefill, server.decode
    server.prefill = wrap(pre, raw["prefill"])
    server.decode = wrap(dec, raw["decode"])
    try:
        reqs = [Request(i, p, max_new=sizes.decode_steps)
                for i, p in enumerate(prompts)]
        server.serve(reqs)
    finally:
        server.prefill, server.decode = pre, dec
    if len(raw["prefill"]) != 1 or len(raw["decode"]) != sizes.decode_steps:
        raise AssertionError(f"spread: {len(raw['prefill'])} prefills and "
                             f"{len(raw['decode'])} decode steps in a round, "
                             f"want 1 and {sizes.decode_steps}")
    return raw, [r.out_tokens for r in reqs]


def round_samples(raw, frames, cuda) -> dict:
    """A timed round's samples by metric, ms (CNN frames/s per request)."""
    out = {}
    for name, prefix in CALLS:
        wall = [w * 1e3 for w, _ in raw[name]]
        out[f"{prefix}_ms" if prefix != "cnn" else "cnn_latency_ms"] = wall
        if cuda:
            out[f"{prefix}_enqueue_ms"] = [e * 1e3 for _, e in raw[name]]
    out["cnn_frames_per_s"] = [frames / (w / 1e3)
                               for w in out["cnn_latency_ms"]]
    return out


def device_split(raw, metrics) -> dict:
    """By call prefix: the traced round's device ms (``summary``), the timed
    rounds' median wall, the host ms (their difference) and host share."""
    out = {}
    for (name, prefix), wall in zip(CALLS, WALL_METRICS):
        dev = summary(raw[name])
        med = metrics[wall]["median"]
        out[prefix] = {"device_ms": dev, "wall_ms_median": med,
                       "host_ms": med - dev["median"],
                       "host_share": (med - dev["median"]) / med}
    return out


def main(device: str = "cuda", rounds: int = ROUNDS) -> dict:
    """R timed rounds and one traced round of both paths, at the served
    sizes on the card and the stand-ins on the CPU (no traced round);
    writes and returns the record."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spread: no CUDA device (pass --device cpu for a "
                           "host rehearsal at stand-in sizes)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"spread: device {device!r}, want cuda or cpu")
    if rounds < 1:
        raise ValueError(f"spread: rounds {rounds}, want at least 1")
    cuda = dev.type == "cuda"
    sizes = served_sizes() if cuda else stand_in_sizes()
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_build = time.perf_counter()
    request, xs = build_cnn(sizes, dev)
    server, prompts = build_lm(sizes, dev)
    paths = (sizes, request, xs, server, prompts)

    def timing(fn, samples):
        return timed(fn, samples, cuda)
    serve_round(*paths, timing)    # warm-up
    build_s = time.perf_counter() - t_build

    samples, per_round, first_tokens = [], [], None
    t_rounds = time.perf_counter()
    for _ in range(rounds):
        raw, tokens = serve_round(*paths, timing)
        if first_tokens is None:
            first_tokens = tokens
        elif tokens != first_tokens:
            raise AssertionError(f"spread: round {len(samples) + 1}'s granite "
                                 f"tokens differ from round 1's")
        s = round_samples(raw, sizes.frames, cuda)
        s["probe_python_ms"] = [python_probe_ms()]
        state = {"loadavg_1m": os.getloadavg()[0],
                 "cpus": len(os.sched_getaffinity(0))}
        if cuda:
            s["probe_enqueue_us"] = [enqueue_probe_us(dev)]
            state.update(smi_sample())
        for k, v in state.items():
            s[k] = [v]
        samples.append(s)
        per_round.append({k: float(np.median(v)) for k, v in s.items()})
    rounds_s = time.perf_counter() - t_rounds

    metrics = {k: summary([x for s in samples for x in s[k]])
               for k in samples[0]}
    medians = {}
    for k in samples[0]:
        vals = [r[k] for r in per_round]
        lo, hi = min(vals), max(vals)
        medians[k] = {"values": vals, "min": lo, "max": hi,
                      "max_over_min": hi / lo if lo > 0 else None}
    probes = [p for p in PROBES if p in samples[0]]
    corr = {m: {p: spearman([r[m] for r in per_round],
                            [r[p] for r in per_round]) for p in probes}
            for m in WALL_METRICS}
    cfg = sizes.lm
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "torch": torch.__version__, "rounds": rounds,
           "sizes": {"cnn": sizes.cnn, "frames": sizes.frames,
                     "requests": sizes.requests, "lm": cfg.name,
                     "lm_layers": cfg.n_layers, "batch": sizes.batch,
                     "prompt": sizes.prompt,
                     "decode_steps": sizes.decode_steps},
           "build_s": build_s, "rounds_s": rounds_s, "tokens_equal": True,
           "metrics": metrics, "round_medians": medians,
           "rank_correlation": corr, "per_round": per_round}
    if cuda:
        t_traced = time.perf_counter()
        raw, tokens = serve_round(
            sizes._replace(decode_steps=TRACED_DECODE_STEPS), *paths[1:],
            traced)
        out["traced_s"] = time.perf_counter() - t_traced
        if tokens != [t[:TRACED_DECODE_STEPS] for t in first_tokens]:
            raise AssertionError("spread: the traced round's granite tokens "
                                 "differ from round 1's")
        out["traced"] = device_split(raw, metrics)
        out["card"] = card_line()
    print_table(out)
    print(f"artifact: {dump('spread', out)}")
    return out


def _num(x):
    return f"{x:11.4g}" if x is not None else f"{'-':>11s}"


def print_table(out) -> None:
    probes = [p for p in PROBES if p in out["metrics"]]
    traced = (f", traced round {out['traced_s']:.1f} s" if "traced_s" in out
              else "")
    print(f"spread on {out.get('card', 'the host (stand-in sizes)')}: "
          f"{out['rounds']} rounds of {out['sizes']}; build and warm-up "
          f"{out['build_s']:.1f} s, rounds {out['rounds_s']:.1f} s{traced}; "
          f"granite tokens equal in every round")
    print(f"{'metric':<20s}{'n':>5s}{'median':>11s}{'q1':>11s}{'q3':>11s}"
          f"{'IQR/med':>11s}{'tail':>5s}{'value':>11s}{'rmed min':>11s}"
          f"{'rmed max':>11s}{'max/min':>11s}"
          + "".join(f"{'rho ' + p[6:]:>16s}" for p in probes))
    for k, m in out["metrics"].items():
        r = out["round_medians"][k]
        rho = out["rank_correlation"].get(k, {})
        print(f"{k:<20s}{m['n']:5d}{_num(m['median'])}{_num(m['q1'])}"
              f"{_num(m['q3'])}{_num(m['iqr_over_median'])}"
              f"{'p' + str(m['tail_percentile']) if m['tail_percentile'] else '-':>5s}"
              f"{_num(m['tail'])}{_num(r['min'])}{_num(r['max'])}"
              f"{_num(r['max_over_min'])}"
              + "".join(f"{_num(rho.get(p)):>16s}" for p in probes))
    for prefix, t in out.get("traced", {}).items():
        d = t["device_ms"]
        print(f"{prefix}: device (traced round, n {d['n']}) median "
              f"{d['median']:.4g} ms, q1 {d['q1']:.4g}, q3 {d['q3']:.4g}; "
              f"wall median {t['wall_ms_median']:.4g} ms; host "
              f"{t['host_ms']:.4g} ms ({100 * t['host_share']:.1f}% of wall)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    main(args.device, args.rounds)
