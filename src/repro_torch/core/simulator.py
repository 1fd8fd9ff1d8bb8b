"""Discrete-event simulator of the IMCE's pipelined compute-and-forward
execution (paper §III/§V).

Model
-----
* Frames (inference requests) stream in; several frames are in flight at
  once, bounded by ``max_in_flight`` (the IMCE PUs "run multiple DNN nodes
  concurrently" with finite DRAM buffering).
* A node instance (frame f, node n) becomes *ready* once every predecessor
  instance has finished AND its output has been forwarded to n's PU
  (transfer over shared DRAM + IPI; zero if producer shares the PU).
* Every PU executes one node at a time (exclusive); among ready instances
  it picks the lowest frame first, then the highest bottom-level (classic
  critical-path list-scheduling tiebreak), then node id.  Transfers are
  DMA — they do not occupy the PU.
* Fused activations cost nothing (inside the PU datapath), matching the
  IMCE.

One event loop, compiled
------------------------
There is exactly one event-loop implementation, ``_run_streams``: it
executes any number of *frame streams* over the graph.  A plain
single-model run is the 1-stream special case (``IMCESimulator``); a
multi-tenant union drives one stream per tenant
(``MultiTenantSimulator``).  The subclasses differ only in the stream
structure/weights they hand the loop and in how ``run`` aggregates the
results.

The loop runs over a precompiled :class:`~repro_torch.core.simcontext.SimContext`:
nodes renumbered to dense ``0..N-1`` indices with flat adjacency,
bottom levels, per-node execution/transfer times and replica phase
tables all hoisted out of the hot path, and per-frame state held in
preallocated slot arrays instead of ``(stream, frame, node)`` dicts.
Contexts are cached on the graph and shared across the three passes of
``run()``, across ``lblp-r`` ``validate_rate`` probes, across
``ElasticSession`` events and across benchmark sweep cells.  The event
sequence is identical to the historical dict-keyed loop (kept in
``core._sim_reference`` as an oracle): in the default ``mode="exact"``
every returned float is bit-identical, pinned by
``tests/test_sim_equivalence.py`` goldens and the property tests in
``tests/test_sim_property.py``.

Periodic steady-state early exit (``mode="periodic"``)
------------------------------------------------------
Deterministic closed-loop runs settle into an exactly periodic regime:
once the complete simulator state (per-PU ready queues, in-flight frame
progress, pending events — all relative to the current time and frame
count) recurs, the future is the past shifted by one period, so the
loop can extrapolate the remaining completions, injections and busy
intervals instead of simulating them.  Exact recurrence almost never
happens in floating point (absolute-time rounding perturbs relative
gaps by ulps), so ``mode="periodic"`` quantizes all execution and
transfer costs onto an integer picosecond grid (exact float arithmetic
below 2**53) where recurrence provably fires, detects it with
exact-match state fingerprints taken at frame completions, and
extrapolates *exactly* on that grid; results are converted back to
seconds on return.  Consequences:

* reported times differ from ``mode="exact"`` only by the ~1e-6
  relative cost quantization plus, on multi-stream runs, the weight
  rationalization described below (well under the model's fidelity);
* the extrapolated tail reports the *infinite-stream periodic regime*
  sampled for ``frames`` completions per stream — the finite-budget
  drain tail (slightly less contention once some stream stops
  injecting) is excluded by design, which is the better steady-state
  estimate;
* open-loop (``rates=``) runs never early-exit; they still benefit from
  the compiled loop and the quantized grid.

Multi-stream steady state (fair-queueing shift invariance)
----------------------------------------------------------
Multi-stream closed-loop runs order ready work by start-time fair
queueing: a frame ``f`` of stream ``s`` carries virtual time
``f * w_s``.  With arbitrary float weights the interleave is
*aperiodic* (the relative order of ``f_s * w_s`` values never repeats —
a Beatty-sequence effect), which is why multi-tenant runs historically
could not early-exit.  In quantized mode the weights themselves are
therefore rationalized (``simcontext.quantize_stream_weights``): each
weight becomes an exact integer whose pairwise ratios are small
rationals, making every virtual-time comparison exact integer
arithmetic.  On such weights the interleave is invariant under shifting
every stream ``s`` by ``dF_s`` frames whenever the *virtual-time
advance* ``dF_s * W_s`` is equal across streams — precisely the
condition a fingerprint match enforces, because the fingerprint records
the quantized virtual-time *gaps* ``injected_s * W_s - injected_0 *
W_0`` between streams alongside the per-slot relative state (stream,
frame offset from that stream's completion count, remaining-sink count,
and an O(1) integer digest of the missing-predecessor vector).
Fingerprints are sampled at stream-0 completions once every stream has
both filled its pipeline and retains injection budget; a match yields
the joint period ``(dF_0..dF_{S-1}, T)`` and all streams' remaining
completions, injections and busy intervals are extrapolated together —
exactly, on the integer grid.  The extrapolation and the tick->seconds
conversion are vectorized with numpy when it is importable (bit-equal
to the scalar fallback: every quantity is an integer-valued float, so
batched arithmetic cannot round differently).

Layer replication (LRMP-style)
------------------------------
Nodes cloned by ``Graph.replicate(node_id, k)`` carry
``replica_index``/``replica_count`` tags; the loop routes frame ``f`` to
replica ``f % k`` (round-robin split) and consumers merge transparently —
an inactive replica simply does not exist for that frame.  The analytic
bound uses the amortized per-frame load (``CostModel.frame_time``).

Measurements
------------
* ``latency``   — the paper's latency metric: mean frame *sojourn* time
  (completion - injection) in double-buffered streaming (``in_flight=2``,
  capture/process overlap, the standard camera-pipeline operating point).
  This reproduces the paper's latency behaviour: it decreases with #PUs
  (queueing shrinks) and converges across algorithms when every node has
  its own PU.  An isolated single-frame makespan is also reported
  (``latency_isolated``); on mostly-sequential CNNs it is
  mapping-invariant up to transfer costs, which is why the streaming
  sojourn must be the figure-of-merit (see EXPERIMENTS.md).
* ``interval``  — steady-state time between consecutive frame completions
  at saturation (deep pipelining); processing rate is ``1/interval``.
* ``utilization`` — per-PU busy fraction over the steady-state window
  (paper Table I).

The analytic pipeline bound ``interval >= max_pu(amortized busy per
frame)`` is asserted (within epsilon) in tests; LBLP's load balancing
minimizes exactly that bound, and LBLP-R lowers it further by
replicating the bottleneck node.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field, replace
from heapq import heappop, heappush
from typing import Dict, List, Optional, Tuple, Union

try:  # vectorized extrapolation/conversion; scalar fallback is bit-equal
    import numpy as _np
except ImportError:  # pragma: no cover - minimal-deps environments
    _np = None

from .cost import CostModel
from .graph import Graph, MultiTenantGraph
from .schedulers.base import Assignment
from .simcontext import (MEMO_CAP, TIME_SCALE, SimContext,
                         quantize_stream_weights)

# event kinds of the compiled loop (ints: never compared by the heap —
# the (time, seq) prefix is already a total order — but cheap to branch on)
_INJECT, _READY, _ARRIVE, _DISPATCH, _DONE, _COMPLETE = range(6)

#: steady-state detection arms only at or beyond this per-stream frame
#: budget (smaller runs have no tail worth extrapolating)
_DETECT_MIN_FRAMES = 24
#: cap on remembered state fingerprints per run (memory guard; a run
#: whose state never recurs within the cap simply completes normally)
_DETECT_MAX_STATES = 512
#: multi-stream detection assumes in-flight frame ids stay within this
#: many frames *behind* the stream's completion count (round-robin
#: replicas complete slightly out of order); a state violating it is
#: simply not sampled, so the bound is safe by construction
_MAX_OOO_FRAMES = 8
#: numpy pays off on the extrapolation/conversion batches only beyond
#: roughly this many items; below it the scalar loops win (identical
#: values either way — the choice is pure speed)
_VECTOR_MIN = 192
#: debug hook: when a list, every detection sample appends (t, rel, key)
_DEBUG_SAMPLES: Optional[list] = None


def slo_headroom(rate: float, latency: float,
                 min_rate: Optional[float] = None,
                 max_latency: Optional[float] = None) -> float:
    """Smallest relative margin of attained figures to a promise:
    positive iff every promised dimension is met (``inf`` when nothing
    is promised).  Rate margin is ``rate/min_rate - 1``; latency margin
    is ``1 - latency/max_latency`` — both are signed fractions of the
    promise, so the min is the binding dimension.  The single source of
    the formula: :meth:`TenantMetrics.slo_headroom` and
    ``serving.SLO.headroom`` both delegate here."""
    h = math.inf
    if min_rate is not None and min_rate > 0:
        h = min(h, rate / min_rate - 1.0)
    if max_latency is not None and max_latency > 0:
        h = min(h, 1.0 - latency / max_latency)
    return h


@dataclass
class TenantMetrics:
    """Steady-state figures of one tenant's frame stream (multi-tenant runs)."""

    tenant: str
    frames: int                         # completed frames
    rate: float                         # tenant frames/s at steady state
    interval: float                     # steady-state per-frame interval [s]
    latency: float                      # mean steady-state sojourn [s]
    bound_interval: float               # tenant's own max per-PU load bound
    busy: Dict[int, float]              # pu_id -> busy seconds for this tenant
    utilization_share: float            # tenant busy / fleet busy (whole run)
    injected_rate: Optional[float] = None  # requested open-loop rate, if any

    # -- SLO evaluation (consumed by the serving tier) -----------------------
    def slo_headroom(self, min_rate: Optional[float] = None,
                     max_latency: Optional[float] = None) -> float:
        """Smallest relative margin to the promise — see the
        module-level :func:`slo_headroom`."""
        return slo_headroom(self.rate, self.latency, min_rate, max_latency)

    def meets_slo(self, min_rate: Optional[float] = None,
                  max_latency: Optional[float] = None) -> bool:
        return self.slo_headroom(min_rate, max_latency) >= 0.0


@dataclass
class SimResult:
    latency: float                      # streaming sojourn latency [s]
    latency_isolated: float             # single-frame makespan [s]
    interval: float                     # steady-state per-frame interval [s]
    rate: float                         # 1/interval [frames/s]
    makespan: float                     # full streaming-run span [s]
    frames: int
    busy: Dict[int, float]              # pu_id -> busy seconds (whole run)
    utilization: Dict[int, float]       # pu_id -> busy fraction, steady window
    mean_utilization: float
    per_frame_busy: Dict[int, float]    # pu_id -> amortized busy s per frame
    bound_interval: float               # analytic max-load bound
    meta: dict = field(default_factory=dict)
    tenants: Dict[str, TenantMetrics] = field(default_factory=dict)

    # -- SLO evaluation (consumed by the serving tier) -----------------------
    def slo_headroom(self, slos: Dict[str, Tuple[Optional[float],
                                                 Optional[float]]]
                     ) -> Dict[str, float]:
        """Per-tenant SLO headroom over a ``tenant -> (min_rate,
        max_latency)`` promise map (see
        :meth:`TenantMetrics.slo_headroom`).  Every promised tenant must
        be present in ``self.tenants``."""
        return {t: self.tenants[t].slo_headroom(mr, ml)
                for t, (mr, ml) in slos.items()}

    def meets_slos(self, slos: Dict[str, Tuple[Optional[float],
                                               Optional[float]]]) -> bool:
        return all(h >= 0.0 for h in self.slo_headroom(slos).values())


@dataclass
class _StreamView:
    """How the event loop sees the graph's frame streams.

    ``IMCESimulator`` exposes one stream spanning the whole graph;
    ``MultiTenantSimulator`` exposes one per tenant.  ``weight`` is the
    stream's virtual-time increment per frame (start-time fair queueing);
    for a single stream any positive constant yields the historical
    frame-number ordering.  (The compiled loop consumes the same
    structure via ``SimContext``; this view object remains the interface
    of the reference loop in ``core._sim_reference``.)
    """

    streams: List[str]
    nodes: Dict[str, List[int]]         # stream -> member node ids
    sources: Dict[str, List[int]]       # stream -> source node ids
    sinks: Dict[str, List[int]]         # stream -> sink node ids
    stream_of: Dict[int, str]           # node id -> stream
    weight: Dict[str, float]            # stream -> virtual-time weight


class IMCESimulator:
    """Event-driven executor of an ``Assignment`` over a ``Graph``.

    ``mode="exact"`` (default) reproduces the historical event loop
    bit-for-bit; ``mode="periodic"`` runs on the quantized time grid
    with steady-state early exit (see module docstring).
    """

    _context_kind = "single"

    def __init__(self, graph: Graph, cost_model: Optional[CostModel] = None,
                 max_in_flight: int = 0, mode: str = "exact") -> None:
        self.g = graph
        self.cm = cost_model or CostModel()
        self.max_in_flight = max_in_flight  # 0 -> auto (=|PUs|+2)
        if mode not in ("exact", "periodic"):
            raise ValueError(f"mode must be 'exact' or 'periodic', got {mode!r}")
        self.mode = mode
        # compiled structure, shared via the graph-level cache
        self._ctx = SimContext.for_graph(
            graph, self.cm, self._context_kind, self._stream_structure)
        self._blevel = self._ctx.blevel_by_id
        #: events processed by the most recent ``_run_streams`` call
        self.last_events = 0
        #: ``(frames_per_period, period_seconds)`` when the most recent
        #: run early-exited, else None.  Multi-stream runs report the
        #: per-stream frame shifts as a tuple.
        self.last_early_exit: Optional[Tuple[Union[int, tuple], float]] = None
        # identity-keyed memo of the last assignment's stream weights
        # (``run`` probes the loop several times with one assignment)
        self._wts_cache: Optional[tuple] = None

    # -- public API -----------------------------------------------------------
    def _run_memo_key(self, assignment: Assignment, frames: int,
                      rates: Optional[Dict[str, float]] = None
                      ) -> Optional[tuple]:
        """Content key of a full ``run()`` — the result is a pure
        function of it.  Cached on the shared context so serving the
        same schedule repeatedly (model registries, repeated benchmark
        cells over one graph object) evaluates once."""
        return ("run", type(self).__name__, self.mode, frames,
                self.max_in_flight,
                tuple(sorted(assignment.mapping.items())),
                tuple((p.pu_id, p.pu_type, p.speed, p.weight_capacity)
                      for p in assignment.pus),
                None if rates is None else tuple(sorted(rates.items())))

    @staticmethod
    def _copy_result(res: SimResult) -> SimResult:
        """Copy deep enough that callers mutating a returned result's
        dict fields cannot corrupt the cache entry (dataclasses.replace
        alone would share the nested dicts)."""
        return replace(
            res,
            busy=dict(res.busy),
            utilization=dict(res.utilization),
            per_frame_busy=dict(res.per_frame_busy),
            meta={k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in res.meta.items()},
            tenants={t: replace(m, busy=dict(m.busy))
                     for t, m in res.tenants.items()},
        )

    def _run_memo_get(self, key: tuple) -> Optional[SimResult]:
        hit = self._ctx.memo.get(key)
        if hit is None:
            return None
        res, early_exit, events = hit
        # a hit must leave the diagnostics describing this run, not
        # whatever the simulator did last
        self.last_early_exit = early_exit
        self.last_events = events
        return self._copy_result(res)

    def _run_memo_put(self, key: tuple, res: SimResult) -> None:
        memo = self._ctx.memo
        while len(memo) >= MEMO_CAP:
            memo.pop(next(iter(memo)))
        memo[key] = (self._copy_result(res), self.last_early_exit,
                     self.last_events)

    def run(self, assignment: Assignment, frames: int = 64) -> SimResult:
        """Full evaluation: isolated latency run + double-buffered latency
        run + saturated streaming throughput run."""
        memo_key = self._run_memo_key(assignment, frames)
        hit = self._run_memo_get(memo_key)
        if hit is not None:
            return hit
        isolated, _, _, _ = self._simulate(assignment, frames=1, in_flight=1)
        # double-buffered sojourn latency (the paper's latency metric)
        _, _, _, sojourns = self._simulate(
            assignment, frames=max(frames // 2, 16), in_flight=2
        )
        k = len(sojourns) // 4
        steady = sojourns[k:] or sojourns
        latency = sum(steady) / len(steady)
        in_flight = self.max_in_flight or (len(assignment.pus) + 2)
        makespan, comps_by_stream, busy, _, busy_by_stream = self._run_streams(
            assignment, frames=frames, in_flight=in_flight
        )
        completions = comps_by_stream[next(iter(comps_by_stream))]
        interval, util_window = self._steady_state(completions)
        busy_window = self._busy_in_window(busy, *util_window)
        window_span = max(util_window[1] - util_window[0], 1e-18)
        utilization = {p: b / window_span for p, b in busy_window.items()}
        per_frame_busy = self._per_frame_busy(assignment)
        bound = max(per_frame_busy.values()) if per_frame_busy else 0.0
        if self.mode == "periodic":
            # the loop already accumulated per-stream busy seconds; on
            # the integer grid the sum is exact, no need to re-walk the
            # (possibly extrapolated) interval lists
            total_busy = {p: 0.0 for p in busy}
            for d in busy_by_stream.values():
                for p, v in d.items():
                    total_busy[p] += v
        else:
            total_busy = {p: sum(iv[1] - iv[0] for iv in ivs)
                          for p, ivs in busy.items()}
        res = SimResult(
            latency=latency,
            latency_isolated=isolated,
            interval=interval,
            rate=1.0 / interval if interval > 0 else math.inf,
            makespan=makespan,
            frames=frames,
            busy=total_busy,
            utilization=utilization,
            mean_utilization=sum(utilization.values()) / max(len(utilization), 1),
            per_frame_busy=per_frame_busy,
            bound_interval=bound,
            meta={"algorithm": assignment.algorithm, "in_flight": in_flight},
        )
        self._run_memo_put(memo_key, res)
        return res

    def latency_only(self, assignment: Assignment) -> float:
        """Isolated single-frame makespan."""
        latency, _, _, _ = self._simulate(assignment, frames=1, in_flight=1)
        return latency

    # -- stream structure ------------------------------------------------------
    def _stream_structure(self):
        """One stream spanning the whole graph (single-model serving):
        ``(streams, members, sources, sinks, stream_of)`` with node ids."""
        g = self.g
        key = g.name
        order = g.topo_order()
        return ([key], {key: order}, {key: g.sources()}, {key: g.sinks()},
                {n: key for n in order})

    def _stream_weights(self, a: Assignment) -> Dict[str, float]:
        """Virtual-time weight per stream; any constant for one stream."""
        return {self.g.name: 1.0}

    def _stream_view(self, a: Assignment) -> _StreamView:
        """Legacy view object (consumed by the reference loop)."""
        streams, nodes, sources, sinks, stream_of = self._stream_structure()
        return _StreamView(streams, nodes, sources, sinks, stream_of,
                           self._stream_weights(a))

    # -- internals -----------------------------------------------------------
    def _per_frame_busy(self, a: Assignment) -> Dict[int, float]:
        out = {p.pu_id: 0.0 for p in a.pus}
        for nid, pid in a.mapping.items():
            pu = a.pu_by_id(pid)
            out[pid] += self.cm.frame_time(self.g.nodes[nid], pu.pu_type, pu.speed)
        return out

    def _simulate(self, a: Assignment, frames: int, in_flight: int,
                  ) -> Tuple[float, List[float],
                             Dict[int, List[Tuple[float, float]]], List[float]]:
        """Single-stream adapter over the shared event loop (kept for the
        historical return shape: makespan, completions, busy, sojourns).
        On a multi-stream view every stream gets ``frames`` and the first
        stream's completions/sojourns are reported."""
        makespan, completions, busy_iv, sojourns, _ = self._run_streams(
            a, frames=frames, in_flight=in_flight)
        first = next(iter(completions))
        return makespan, completions[first], busy_iv, sojourns[first]

    def _run_streams(
        self, a: Assignment, frames, in_flight: int,
        rates: Optional[Dict[str, float]] = None,
        light: bool = False,
    ) -> Tuple[float, Dict[str, List[float]],
               Dict[int, List[Tuple[float, float]]],
               Dict[str, List[float]], Dict[str, Dict[int, float]]]:
        """THE event loop: stream-keyed frames over one graph, compiled.

        A frame instance is ``(stream, f)`` and only traverses the
        stream's member nodes; replicated nodes additionally serve only
        the frames of their round-robin slot.  Two injection regimes:
        closed-loop (bounded in-flight, re-inject on completion) and
        open-loop (``rates``: frame f injected at ``f / rate``).

        ``frames`` is a per-stream dict, or an int applied to every
        stream of the view.  Returns ``(makespan, completions-by-stream,
        busy intervals per PU, sojourns-by-stream,
        busy-by-stream-by-PU)``.  ``light`` callers (rate probes) only
        read completions; the busy/sojourn materialization is skipped.
        """
        ctx = self._ctx
        quant = self.mode == "periodic"
        plan = ctx.plan(a, self.cm, quant)
        skeys = ctx.stream_keys
        S = len(skeys)
        if isinstance(frames, int):
            frames = {s: frames for s in skeys}
        fcount = [frames[s] for s in skeys]
        wts = self._cached_weights(a)
        w_arr = [wts[s] for s in skeys]

        n = ctx.n
        node_ids = ctx.ids
        negbl = ctx.negbl
        exec_t = plan.exec_t
        pu_of = plan.pu_of
        npu = len(plan.pu_ids)
        members = ctx.members
        preds = ctx.preds
        succs = ctx.succs
        is_active = ctx.active

        replicated = ctx.replicated
        phased = ctx.phases_compiled
        period = ctx.phase_period
        dyn = replicated and not phased
        arrive_tbl = plan.arrive
        arrive_0 = arrive_tbl[0]
        base_missing = ctx.base_missing
        init_ready = ctx.init_ready
        phase_sinks = ctx.phase_sinks
        base_digest = ctx.base_digest
        dpow = ctx.digest_pow

        detect = (quant and rates is None and not dyn and bool(fcount)
                  and min(fcount) >= _DETECT_MIN_FRAMES)
        if quant and rates is None and S > 1:
            # integer virtual-time weights with small-rational ratios:
            # exact vt arithmetic makes the fair-queueing interleave
            # frame-shift invariant, the precondition for multi-stream
            # steady-state recurrence (see module docstring)
            qw = quantize_stream_weights(w_arr, max(fcount))
            if qw is None:
                detect = False
            else:
                w_arr = qw
        track = detect  # maintain slot digests (fingerprint ingredients)

        # Pairwise virtual-time gaps (multi-stream detection): a
        # cross-stream vt comparison can only depend on the *exact* gap
        # while it sits inside the discrimination band (in-flight frames
        # of both streams could tie); beyond the band the lagging stream
        # has strict priority and only the gap's sign matters — tenants
        # whose steady rates are not in inverse weight ratio drift there
        # and stay (the gap moves monotonically per period).  The
        # fingerprint therefore records the exact gap inside the band
        # and a sign sentinel outside it; sentinel matches are verified
        # against the sampled trail before extrapolating (gap never
        # re-entered the band in the window, and drifts away from it).
        pair_defs = [
            (u, v, (in_flight + _MAX_OOO_FRAMES + 1) * (w_arr[u] + w_arr[v]))
            for u in range(S) for v in range(u + 1, S)
        ] if detect and S > 1 else []

        # events are (time, seq, kind, x, y, z); processing order is the
        # total order by (time, seq), exactly the historical heap order.
        # Two lanes carry them: `evq` (heap) for future events and `dq`
        # (FIFO) for events scheduled at the current instant — same-time
        # events dominate (ready/dispatch/complete, zero-cost transfers)
        # and a deque append/popleft is far cheaper than a heap sift.
        # Routing is a pure optimization: the merge pop below compares
        # (time, seq) across both lanes, so any routing is correct.
        evq: List[Tuple[float, int, int, int, int, int]] = []
        dq: deque = deque()
        now = None  # time of the event being processed
        seq = 0

        # per-frame-slot state (slot = one in-flight frame instance)
        slot_stream: List[int] = []
        slot_frame: List[int] = []
        slot_left: List[int] = []
        slot_missing: List[Optional[List[int]]] = []
        slot_digest: List[int] = []
        free_slots: List[int] = []

        inject_t: List[List[Optional[float]]] = [[None] * fcount[s] for s in range(S)]
        complete_t: List[List[Optional[float]]] = [[None] * fcount[s] for s in range(S)]
        injected = [0] * S
        completions: List[List[float]] = [[] for _ in range(S)]
        ready_q: List[List[tuple]] = [[] for _ in range(npu)]
        pu_free_at = [0.0] * npu
        pu_idle = [True] * npu
        busy_iv: List[List[Tuple[float, float]]] = [[] for _ in range(npu)]
        stream_busy = [[0.0] * npu for _ in range(S)]

        # an exact state match is sound even mid-transient (identical
        # state => identical future), so arm as soon as the pipeline can
        # possibly have filled on every stream
        warmup = max(in_flight, 4)
        armed = False
        fp_map: Dict[tuple, tuple] = {}
        trail: List[Tuple[int, ...]] = []  # per-sample completion vectors
        comp_frames: List[List[int]] = [[] for _ in range(S)]
        busy_frame: List[List[int]] = [[] for _ in range(npu)]
        busy_strm: Optional[List[List[int]]] = \
            [[] for _ in range(npu)] if S > 1 else None
        self.last_early_exit = None

        def push(t: float, kind: int, x: int, y: int, z: int) -> None:
            nonlocal seq
            if t == now:
                dq.append((t, seq, kind, x, y, z))
            else:
                heappush(evq, (t, seq, kind, x, y, z))
            seq += 1

        def inject(s: int, f: int, t: float) -> None:
            inject_t[s][f] = t
            if free_slots:
                slot = free_slots.pop()
            else:
                slot = len(slot_frame)
                slot_stream.append(0)
                slot_frame.append(0)
                slot_left.append(0)
                slot_missing.append(None)
                slot_digest.append(0)
            slot_stream[slot] = s
            slot_frame[slot] = f
            if not dyn:
                ph = f % period
                slot_missing[slot] = base_missing[s][ph][:]
                slot_left[slot] = phase_sinks[s][ph]
                if track:
                    slot_digest[slot] = base_digest[s][ph]
                for j in init_ready[s][ph]:
                    push(t, _READY, slot, j, 0)
            else:
                # per-frame view: inactive replicas do not exist for f
                # (lcm of replica counts too large to precompile phases)
                miss = [0] * n
                sinks = 0
                for j in members[s]:
                    if not is_active(j, f):
                        continue
                    miss[j] = sum(1 for p in preds[j] if is_active(p, f))
                    if not any(is_active(k, f) for k in succs[j]):
                        sinks += 1
                    if miss[j] == 0:
                        push(t, _READY, slot, j, 0)
                slot_missing[slot] = miss
                slot_left[slot] = sinks
            injected[s] += 1

        def fingerprint(t: float, rel: List[int]) -> Optional[tuple]:
            """Canonical relative state at a stream-0 frame completion:
            identical fingerprints => identical future evolution shifted
            in time and per-stream frame numbers (exact on the quantized
            grid with integer virtual-time weights).  ``rel`` is the
            per-stream completion count, the frame-number reference.
            Returns None when the state violates the bounded
            out-of-order assumption the gap band relies on."""
            ev = []
            for (te, _sq, k, x, y, z) in sorted(list(evq) + list(dq)):
                if k == _READY or k == _ARRIVE:
                    sx = slot_stream[x]
                    ev.append((te - t, k, sx, slot_frame[x] - rel[sx], y))
                elif k == _DISPATCH:
                    ev.append((te - t, k, x, 0))
                elif k == _DONE:
                    sy = slot_stream[y]
                    ev.append((te - t, k, sy, slot_frame[y] - rel[sy], z, x))
                else:  # _COMPLETE
                    sx = slot_stream[x]
                    ev.append((te - t, k, sx, slot_frame[x] - rel[sx]))
            rq = tuple(
                tuple(sorted(
                    (slot_stream[e[5]], e[1] - rel[slot_stream[e[5]]], e[3])
                    for e in ready_q[p]))
                for p in range(npu)
            )
            frees = set(free_slots)
            slots = []
            for i in range(len(slot_frame)):
                if i in frees:
                    continue
                off = slot_frame[i] - rel[slot_stream[i]]
                if off < -_MAX_OOO_FRAMES and pair_defs:
                    return None
                slots.append((slot_stream[i], off, slot_left[i],
                              slot_digest[i]))
            slots.sort()
            # quantized virtual-time gaps per stream pair, clamped at
            # the discrimination band: inside it equality forces the
            # pair's dF_s * W_s to one constant (the shift-invariance
            # condition); outside it only the saturated sign is state
            gaps = []
            for (u, v, band) in pair_defs:
                gp = rel[u] * w_arr[u] - rel[v] * w_arr[v]
                if gp > band:
                    gp = math.inf
                elif gp < -band:
                    gp = -math.inf
                gaps.append(gp)
            phases = (tuple(r % period for r in rel) if replicated else None)
            return (tuple(injected[x] - rel[x] for x in range(S)),
                    phases, tuple(gaps), tuple(ev), rq, tuple(pu_idle),
                    tuple(slots))

        def clamped_gaps_ok(i1: int, i2: int, rel: List[int]) -> bool:
            """A sentinel (clamped) gap match is sound iff over the whole
            sampled window the pair's gap kept its sign, stayed clear of
            the discrimination band even between samples (adverse
            per-interval movement subtracted), and the per-period drift
            points away from the band — then every future comparison
            resolves exactly as in the window."""
            for (u, v, band) in pair_defs:
                g2 = rel[u] * w_arr[u] - rel[v] * w_arr[v]
                if -band <= g2 <= band:
                    continue  # exact pair: equality enforced by the key
                sgn = 1.0 if g2 > 0 else -1.0
                g1 = None
                m = abs(g2)
                slack = 0.0
                prev = None
                for i in range(i1, i2 + 1):
                    r = trail[i]
                    gi = r[u] * w_arr[u] - r[v] * w_arr[v]
                    if gi * sgn <= 0:
                        return False
                    if g1 is None:
                        g1 = gi
                    if abs(gi) < m:
                        m = abs(gi)
                    if prev is not None:
                        adverse = ((r[v] - prev[v]) * w_arr[v] if sgn > 0
                                   else (r[u] - prev[u]) * w_arr[u])
                        if adverse > slack:
                            slack = adverse
                    prev = r
                drift = g2 - g1
                if drift != 0 and (drift > 0) != (sgn > 0):
                    return False
                if not m - slack > band:
                    return False
            return True

        # prime / schedule injections
        if rates is not None:
            for s in range(S):
                r = rates[skeys[s]]
                if r <= 0:
                    raise ValueError(f"rate for stream '{skeys[s]}' must be > 0")
                for f in range(fcount[s]):
                    ti = f / r
                    if quant:  # injection times live on the tick grid too
                        ti = float(round(ti * TIME_SCALE))
                    push(ti, _INJECT, s, f, 0)
        else:
            for s in range(S):
                for f in range(min(in_flight, fcount[s])):
                    inject(s, f, 0.0)

        # local bindings: every name below is hit hundreds of thousands
        # of times per run, and LOAD_FAST beats LOAD_GLOBAL/method lookup
        hpush, hpop = heappush, heappop
        dq_append, dq_popleft = dq.append, dq.popleft
        # quant mode processes a ready PU's dispatch inline instead of
        # routing it through the queue (the event round-trip is ~25% of
        # all traffic).  Same-tick races resolve slightly differently
        # than the historical order, which is within the quantized
        # mode's fidelity contract; exact mode keeps the queued path
        # bit-for-bit.
        fuse = quant

        makespan = 0.0
        while True:
            # merge pop: smallest (time, seq) across the two lanes
            if dq:
                if evq:
                    eh = evq[0]
                    dh = dq[0]
                    if eh[0] < dh[0] or (eh[0] == dh[0] and eh[1] < dh[1]):
                        ev = hpop(evq)
                    else:
                        ev = dq_popleft()
                else:
                    ev = dq_popleft()
            elif evq:
                ev = hpop(evq)
            else:
                break
            t, _, kind, x, y, z = ev
            now = t
            makespan = t  # event times are nondecreasing
            if kind == _DISPATCH:
                p = x
                rq = ready_q[p]
                if not pu_idle[p] or not rq:
                    continue
                _vt, f, _nb, _nid, j, slot = hpop(rq)
                dt = exec_t[j]
                pu_idle[p] = False
                free_at = pu_free_at[p]
                start = t if t > free_at else free_at
                end = start + dt
                pu_free_at[p] = end
                if dt > 0:
                    busy_iv[p].append((start, end))
                    s = slot_stream[slot]
                    stream_busy[s][p] += dt
                    if detect:
                        busy_frame[p].append(f)
                        if busy_strm is not None:
                            busy_strm[p].append(s)
                    hpush(evq, (end, seq, _DONE, p, slot, j))
                elif end == t:
                    dq_append((end, seq, _DONE, p, slot, j))
                else:
                    hpush(evq, (end, seq, _DONE, p, slot, j))
                seq += 1
            elif kind == _DONE:
                p, slot, j = x, y, z
                pu_idle[p] = True
                s = slot_stream[slot]
                f = slot_frame[slot]
                if dyn:
                    outs = [pr for pr in arrive_0[j] if is_active(pr[0], f)]
                elif replicated:
                    outs = arrive_tbl[f % period][j]
                else:
                    outs = arrive_0[j]
                if not outs:
                    slot_left[slot] -= 1
                    if slot_left[slot] == 0:
                        completions[s].append(t)
                        complete_t[s][f] = t
                        if detect:
                            comp_frames[s].append(f)
                        dq_append((t, seq, _COMPLETE, slot, 0, 0))
                        seq += 1
                else:
                    for k, xf in outs:
                        if xf:
                            hpush(evq, (t + xf, seq, _ARRIVE, slot, k, 0))
                        else:
                            dq_append((t, seq, _ARRIVE, slot, k, 0))
                        seq += 1
                if ready_q[p]:
                    if fuse:
                        # fused dispatch (quant): run the queued-dispatch
                        # body immediately — the PU is idle and has ready
                        # work, so the event round-trip is pure overhead.
                        # Same-tick races resolve slightly differently
                        # than the historical queued order, within the
                        # quantized mode's fidelity contract; exact mode
                        # always takes the queued path, bit-for-bit.
                        # NOTE: this body is intentionally inlined (a
                        # closure call costs as much as it saves) and
                        # must stay textually identical to the _DISPATCH
                        # handler body and the _READY fused copy below.
                        _vt, f, _nb, _nid, j, slot = hpop(ready_q[p])
                        dt = exec_t[j]
                        pu_idle[p] = False
                        free_at = pu_free_at[p]
                        start = t if t > free_at else free_at
                        end = start + dt
                        pu_free_at[p] = end
                        if dt > 0:
                            busy_iv[p].append((start, end))
                            s = slot_stream[slot]
                            stream_busy[s][p] += dt
                            if detect:
                                busy_frame[p].append(f)
                                if busy_strm is not None:
                                    busy_strm[p].append(s)
                            hpush(evq, (end, seq, _DONE, p, slot, j))
                        elif end == t:
                            dq_append((end, seq, _DONE, p, slot, j))
                        else:
                            hpush(evq, (end, seq, _DONE, p, slot, j))
                        seq += 1
                    else:
                        dq_append((t, seq, _DISPATCH, p, 0, 0))
                        seq += 1
            elif kind == _ARRIVE:
                slot, j = x, y
                m = slot_missing[slot]
                m[j] -= 1
                if track:
                    slot_digest[slot] -= dpow[j]
                if m[j] == 0:
                    dq_append((t, seq, _READY, slot, j, 0))
                    seq += 1
            elif kind == _READY:
                slot, j = x, y
                s = slot_stream[slot]
                f = slot_frame[slot]
                p = pu_of[j]
                hpush(ready_q[p],
                      (f * w_arr[s], f, negbl[j], node_ids[j], j, slot))
                if pu_idle[p]:
                    free_at = pu_free_at[p]
                    te = t if t > free_at else free_at
                    if te == t:
                        if fuse:
                            # fused dispatch — keep identical to the
                            # _DONE fused copy (te == t implies
                            # free_at <= t, so the clamp is a no-op)
                            _vt, f, _nb, _nid, j, slot = hpop(ready_q[p])
                            dt = exec_t[j]
                            pu_idle[p] = False
                            free_at = pu_free_at[p]
                            start = t if t > free_at else free_at
                            end = start + dt
                            pu_free_at[p] = end
                            if dt > 0:
                                busy_iv[p].append((start, end))
                                s = slot_stream[slot]
                                stream_busy[s][p] += dt
                                if detect:
                                    busy_frame[p].append(f)
                                    if busy_strm is not None:
                                        busy_strm[p].append(s)
                                hpush(evq, (end, seq, _DONE, p, slot, j))
                            elif end == t:
                                dq_append((end, seq, _DONE, p, slot, j))
                            else:
                                hpush(evq, (end, seq, _DONE, p, slot, j))
                            seq += 1
                        else:
                            dq_append((te, seq, _DISPATCH, p, 0, 0))
                            seq += 1
                    else:
                        hpush(evq, (te, seq, _DISPATCH, p, 0, 0))
                        seq += 1
            elif kind == _COMPLETE:
                slot = x
                s = slot_stream[slot]
                free_slots.append(slot)
                if rates is None and injected[s] < fcount[s]:
                    inject(s, injected[s], t)
                if detect and s == 0:
                    if any(injected[x] >= fcount[x] for x in range(S)):
                        # some stream started draining: the closed-loop
                        # regime the fingerprints describe has ended
                        detect = False
                        continue
                    if not armed:
                        armed = all(len(completions[x]) >= warmup
                                    for x in range(S))
                    if armed:
                        rel = [len(completions[x]) for x in range(S)]
                        key = fingerprint(t, rel)
                        if key is None:
                            continue
                        if _DEBUG_SAMPLES is not None:
                            _DEBUG_SAMPLES.append((t, tuple(rel), key))
                        trail.append(tuple(rel))
                        entry = (t, tuple(rel),
                                 tuple(len(busy_iv[p]) for p in range(npu)),
                                 len(trail) - 1)
                        prev = fp_map.get(key)
                        if prev is None:
                            if len(fp_map) < _DETECT_MAX_STATES:
                                fp_map[key] = entry
                            else:
                                # state space too large to recur within the
                                # cap: stop paying for fingerprints and run
                                # the rest of the simulation plainly
                                detect = False
                        else:
                            t0, rel0, blens, i1 = prev
                            T = t - t0
                            dF = [rel[x] - rel0[x] for x in range(S)]
                            if not (T > 0 and all(dF)) or (
                                    pair_defs and not clamped_gaps_ok(
                                        i1, len(trail) - 1, rel)):
                                # not (yet) a provably recurring state:
                                # keep the fresher sample — its clamped
                                # gaps have drifted further, so a later
                                # match verifies more easily
                                fp_map[key] = entry
                                continue
                            self._extrapolate(
                                fcount, dF, T, rel0, rel,
                                completions, comp_frames, complete_t,
                                inject_t, injected, busy_iv,
                                busy_frame, busy_strm, blens, stream_busy,
                                light)
                            self.last_early_exit = (
                                dF[0] if S == 1 else tuple(dF),
                                T / TIME_SCALE if quant else T)
                            makespan = max(max(completions[x])
                                           for x in range(S))
                            break
            else:  # _INJECT (open loop)
                inject(x, y, t)

        self.last_events = seq
        if not quant:
            sojourns_g = {
                skeys[s]: [complete_t[s][f] - inject_t[s][f]
                           for f in range(fcount[s])
                           if complete_t[s][f] is not None]
                for s in range(S)
            }
            return (makespan,
                    {skeys[s]: sorted(completions[s]) for s in range(S)},
                    {plan.pu_ids[p]: busy_iv[p] for p in range(npu)},
                    sojourns_g,
                    {skeys[s]: {plan.pu_ids[p]: stream_busy[s][p]
                                for p in range(npu)} for s in range(S)})
        return self._to_seconds(plan, skeys, fcount, makespan, completions,
                                complete_t, inject_t, busy_iv, stream_busy,
                                light)

    @staticmethod
    def _to_seconds(plan, skeys, fcount, makespan, completions, complete_t,
                    inject_t, busy_iv, stream_busy, light=False):
        """Quantized tick grid -> seconds, vectorized when numpy is
        importable (identical values: each element is divided by the
        scale exactly as the scalar path would).  ``light`` callers get
        empty busy/sojourn structures (they only read completions)."""
        S = len(skeys)
        npu = len(plan.pu_ids)
        sc = TIME_SCALE
        if light:
            sojourns_g = {skeys[s]: [] for s in range(S)}
        else:
            sojourns_g = {
                skeys[s]: [(complete_t[s][f] - inject_t[s][f]) / sc
                           for f in range(fcount[s])
                           if complete_t[s][f] is not None]
                for s in range(S)
            }
        comps = {}
        for s in range(S):
            cs = completions[s]
            if _np is not None and len(cs) >= _VECTOR_MIN:
                arr = _np.asarray(cs) / sc
                arr.sort()
                comps[skeys[s]] = arr.tolist()
            else:
                comps[skeys[s]] = sorted(c / sc for c in cs)
        busy = {}
        for p in range(npu):
            # always scalar: numpy round-trips through tuple lists cost
            # more than the comprehension at every size
            ivs = () if light else busy_iv[p]
            busy[plan.pu_ids[p]] = [(b / sc, e / sc) for (b, e) in ivs]
        return (
            makespan / sc,
            comps,
            busy,
            sojourns_g,
            {skeys[s]: {plan.pu_ids[p]: stream_busy[s][p] / sc
                        for p in range(npu)} for s in range(S)},
        )

    def _weights_sig(self) -> Optional[tuple]:
        """Content signature of the serving-weight knobs the stream
        weights depend on (None when there are none)."""
        return None

    def _cached_weights(self, a: Assignment) -> Dict[str, float]:
        sig = self._weights_sig()
        hit = self._wts_cache
        if hit is not None and hit[0] is a and hit[2] == sig:
            return hit[1]
        wts = self._stream_weights(a)
        self._wts_cache = (a, wts, sig)
        return wts

    @staticmethod
    def _extrapolate(fcount: List[int], dF: List[int], T: float,
                     rel0: Tuple[int, ...], rel1: List[int],
                     completions: List[List[float]],
                     comp_frames: List[List[int]],
                     complete_t: List[List[Optional[float]]],
                     inject_t: List[List[Optional[float]]],
                     injected: List[int],
                     busy_iv: List[List[Tuple[float, float]]],
                     busy_frame: List[List[int]],
                     busy_strm: Optional[List[List[int]]],
                     blens: Tuple[int, ...],
                     stream_busy: List[List[float]],
                     light: bool = False) -> None:
        """Exact periodic extrapolation, all streams jointly: the window
        between the two matched states (``dF[s]`` frames of stream ``s``
        over ``T`` ticks) repeats verbatim, shifted by multiples of
        ``(dF, T)``, until every stream's frame budget is met.  All
        arithmetic stays on the integer grid, so the result equals a
        full simulation of the never-draining periodic regime — whether
        it runs through numpy (batched) or the scalar fallback."""
        S = len(fcount)
        # completions (and per-frame completion times for sojourns)
        for s in range(S):
            F, d = fcount[s], dF[s]
            ct_list = complete_t[s]
            frames_w = comp_frames[s][rel0[s]:rel1[s]]
            times_w = completions[s][rel0[s]:rel1[s]]
            if (_np is not None and frames_w
                    and (F - rel1[s]) >= _VECTOR_MIN):
                fw = _np.asarray(frames_w, dtype=_np.int64)
                tw = _np.asarray(times_w)
                k = _np.maximum((F - 1 - fw) // d, 0)
                tot = int(k.sum())
                if tot:
                    idx = _np.repeat(_np.arange(len(fw)), k)
                    csum = _np.concatenate(([0], _np.cumsum(k)[:-1]))
                    step = _np.arange(1, tot + 1) - _np.repeat(csum, k)
                    newt = (tw[idx] + step * T).tolist()
                    completions[s].extend(newt)
                    for f, ct in zip((fw[idx] + step * d).tolist(), newt):
                        ct_list[f] = ct
            else:
                for r in range(len(frames_w)):
                    f = frames_w[r] + d
                    ct = times_w[r] + T
                    while f < F:
                        ct_list[f] = ct
                        completions[s].append(ct)
                        f += d
                        ct += T
            # injections are frame-contiguous in the closed loop
            start = injected[s]
            if _np is not None and start < F and (F - start) >= _VECTOR_MIN:
                fs = _np.arange(start, F, dtype=_np.int64)
                ks = (fs - start) // d + 1
                base = (fs - ks * d).tolist()
                inj = inject_t[s]
                inject_t[s][start:F] = [inj[b] + kk * T
                                        for b, kk in zip(base, ks.tolist())]
            else:
                inj = inject_t[s]
                for f in range(start, F):
                    inj[f] = inj[f - d] + T
        # busy intervals, tagged by (stream, frame) so every stream's
        # budget cut stays exact; rate probes (light) never read them
        for p, ivs in enumerate(() if light else busy_iv):
            if blens[p] >= len(ivs):
                continue
            lo = blens[p]
            frames_p = busy_frame[p]
            if _np is not None and (len(ivs) - lo) >= _VECTOR_MIN // 4:
                fa = _np.asarray(frames_p[lo:], dtype=_np.int64)
                if busy_strm is not None:
                    sa = _np.asarray(busy_strm[p][lo:], dtype=_np.int64)
                    darr = _np.asarray(dF, dtype=_np.int64)[sa]
                    Farr = _np.asarray(fcount, dtype=_np.int64)[sa]
                else:
                    sa = None
                    darr = dF[0]
                    Farr = fcount[0]
                k = _np.maximum((Farr - 1 - fa) // darr, 0)
                tot = int(k.sum())
                if not tot:
                    continue
                be = _np.asarray(ivs[lo:])
                idx = _np.repeat(_np.arange(len(fa)), k)
                csum = _np.concatenate(([0], _np.cumsum(k)[:-1]))
                step = _np.arange(1, tot + 1) - _np.repeat(csum, k)
                shift = step * T
                nb = be[idx, 0] + shift
                ne = be[idx, 1] + shift
                dur = be[idx, 1] - be[idx, 0]
                ivs.extend(zip(nb.tolist(), ne.tolist()))
                if sa is None:
                    stream_busy[0][p] += float(dur.sum())
                else:
                    add = _np.bincount(sa[idx], weights=dur, minlength=S)
                    for s in range(S):
                        stream_busy[s][p] += float(add[s])
            else:
                strm_p = busy_strm[p] if busy_strm is not None else None
                adds = [0.0] * S
                for r in range(lo, len(ivs)):
                    b, e = ivs[r]
                    s = strm_p[r] if strm_p is not None else 0
                    F, d = fcount[s], dF[s]
                    f = frames_p[r] + d
                    dur = e - b
                    bb = b + T
                    while f < F:
                        ivs.append((bb, bb + dur))
                        adds[s] += dur
                        f += d
                        bb += T
                for s in range(S):
                    stream_busy[s][p] += adds[s]
        for s in range(S):
            if (any(c is None for c in complete_t[s])
                    or len(completions[s]) != fcount[s]):
                raise RuntimeError(
                    "periodic extrapolation lost frames — this is a bug; "
                    "re-run with mode='exact'")

    @staticmethod
    def _steady_state(completions: List[float]) -> Tuple[float, Tuple[float, float]]:
        """Mean inter-completion gap over the middle half of the run
        (robust to bursty pipelines where per-gap medians mislead)."""
        n = len(completions)
        if n <= 1:
            t = completions[0] if completions else 0.0
            return (t, (0.0, max(t, 1e-18)))
        lo = n // 4
        window = completions[lo:]
        if len(window) < 2 or window[-1] <= window[0]:
            return (completions[-1] / max(n - 1, 1),
                    (completions[0], completions[-1]))
        interval = (window[-1] - window[0]) / (len(window) - 1)
        return interval, (window[0], window[-1])

    @staticmethod
    def _busy_in_window(busy: Dict[int, List[Tuple[float, float]]],
                        w0: float, w1: float) -> Dict[int, float]:
        out = {}
        for pid, ivs in busy.items():
            acc = 0.0
            for a, b in ivs:
                if b <= w0 or a >= w1:
                    continue
                lo = a if a > w0 else w0
                hi = b if b < w1 else w1
                acc += hi - lo
            out[pid] = acc
        return out


class MultiTenantSimulator(IMCESimulator):
    """Multi-tenant front-end over the shared event loop.

    Every tenant receives its own frame stream.  Two injection regimes:

    * **closed-loop** (``rates=None``): each tenant keeps a bounded number
      of frames in flight and re-injects on completion — the saturated
      operating point; per-tenant rate is the tenant's fair-share
      throughput under contention.
    * **open-loop** (``rates={tenant: frames/s}``): frame ``f`` of a
      tenant is injected at ``f / rate`` regardless of completions, the
      serving-under-traffic operating point; sojourn latency then includes
      queueing behind both the tenant's own backlog and the co-tenants.

    ``run`` returns an aggregate :class:`SimResult` whose ``tenants`` dict
    carries per-tenant rate, steady-state sojourn latency, busy seconds
    and utilization share.
    """

    _context_kind = "mt"

    def __init__(self, graph: MultiTenantGraph,
                 cost_model: Optional[CostModel] = None,
                 max_in_flight: int = 0, mode: str = "exact") -> None:
        if not isinstance(graph, MultiTenantGraph):
            raise TypeError("MultiTenantSimulator needs a MultiTenantGraph")
        super().__init__(graph, cost_model, max_in_flight, mode)

    # -- stream structure ------------------------------------------------------
    def _stream_structure(self):
        """One stream per tenant."""
        g: MultiTenantGraph = self.g  # type: ignore[assignment]
        tenants = list(g.tenants)
        return (tenants,
                {t: g.tenant_nodes(t) for t in tenants},
                {t: g.tenant_sources(t) for t in tenants},
                {t: g.tenant_sinks(t) for t in tenants},
                {n: g.tenant_of(n) for n in g.topo_order()})

    def _stream_weights(self, a: Assignment) -> Dict[str, float]:
        """Start-time fair queueing weights: a tenant's frame f carries
        virtual time ``f * (its amortized busy seconds per frame)``.
        Ordering ready work by virtual time equalizes *resource* shares
        instead of completion counts — a light tenant streams several
        frames per heavy-tenant frame rather than being locked to the
        heavy tenant's pace (which would cap aggregate rate at
        n_tenants / heaviest-round).

        Per-tenant serving weights (``MultiTenantGraph.tenant_weight``)
        scale the entitlement: dividing the virtual-time increment by
        the weight gives a weight-w tenant w times the fleet share of a
        weight-1 tenant (classic weighted fair queueing).  The default
        weight of 1.0 reproduces the historical equal-share ordering
        bit-for-bit."""
        g: MultiTenantGraph = self.g  # type: ignore[assignment]
        tl = self._cached_tenant_load(a)
        return {t: (max(sum(tl.get(t, {0: 0.0}).values()), 1e-18)
                    / g.tenant_weight(t))
                for t in g.tenants}

    def _cached_tenant_load(self, a: Assignment):
        hit = getattr(self, "_tl_cache", None)
        if hit is not None and hit[0] is a:
            return hit[1]
        tl = a.tenant_load(self.g, self.cm)
        self._tl_cache = (a, tl)
        return tl

    def _run_memo_key(self, assignment: Assignment, frames: int,
                      rates: Optional[Dict[str, float]] = None
                      ) -> Optional[tuple]:
        # tenant serving weights change the fair-queueing interleave
        # without any structural mutation, so the content key must carry
        # them (the serving tier re-weights tenants on one union object)
        g: MultiTenantGraph = self.g  # type: ignore[assignment]
        base = super()._run_memo_key(assignment, frames, rates)
        return base + (tuple(g.tenant_weight(t) for t in g.tenants),)

    def _weights_sig(self) -> Optional[tuple]:
        g: MultiTenantGraph = self.g  # type: ignore[assignment]
        return tuple(g.tenant_weight(t) for t in g.tenants)

    # -- public API -----------------------------------------------------------
    def run(self, assignment: Assignment, frames: int = 64,
            rates: Optional[Dict[str, float]] = None) -> SimResult:
        g: MultiTenantGraph = self.g  # type: ignore[assignment]
        tenants = list(g.tenants)
        if rates is not None and set(rates) != set(tenants):
            raise ValueError(
                f"rates keys {sorted(rates)} != tenants {sorted(tenants)}")
        memo_key = self._run_memo_key(assignment, frames, rates)
        hit = self._run_memo_get(memo_key)
        if hit is not None:
            return hit

        # truly isolated per-tenant single-frame makespans: each tenant
        # alone on the fleet, no co-tenant contention (keeps the field's
        # 'isolated' semantics comparable with single-tenant runs; the
        # scalar is the worst tenant).
        iso_by_tenant: Dict[str, float] = {}
        for t in tenants:
            mk, *_ = self._run_streams(
                assignment, {u: (1 if u == t else 0) for u in tenants},
                in_flight=1)
            iso_by_tenant[t] = mk
        isolated = max(iso_by_tenant.values(), default=0.0)

        if rates is None:
            # double-buffered sojourn latency run (paper's latency metric)
            lat_frames = {t: max(frames // 2, 16) for t in tenants}
            _, _, _, lat_sojourns, _ = self._run_streams(
                assignment, lat_frames, in_flight=2)
            in_flight = self.max_in_flight or (len(assignment.pus) + 2)
            makespan, completions, busy_iv, sojourns, tenant_busy = \
                self._run_streams(assignment, {t: frames for t in tenants},
                                  in_flight=in_flight)
        else:
            in_flight = 0  # open loop: injection is time-driven
            makespan, completions, busy_iv, sojourns, tenant_busy = \
                self._run_streams(assignment, {t: frames for t in tenants},
                                  in_flight=0, rates=rates)
            lat_sojourns = sojourns

        def steady_mean(xs: List[float]) -> float:
            if not xs:
                return 0.0
            steady = xs[len(xs) // 4:] or xs
            return sum(steady) / len(steady)

        merged = sorted(t for comps in completions.values() for t in comps)
        interval, util_window = self._steady_state(merged)
        busy_window = self._busy_in_window(busy_iv, *util_window)
        window_span = max(util_window[1] - util_window[0], 1e-18)
        utilization = {p: b / window_span for p, b in busy_window.items()}
        per_frame_busy = self._per_frame_busy(assignment)
        bound = max(per_frame_busy.values()) if per_frame_busy else 0.0

        fleet_busy = sum(sum(d.values()) for d in tenant_busy.values())
        tenant_load = self._cached_tenant_load(assignment)
        per_tenant: Dict[str, TenantMetrics] = {}
        for t in tenants:
            t_interval, _ = self._steady_state(completions[t])
            t_busy = tenant_busy.get(t, {})
            per_tenant[t] = TenantMetrics(
                tenant=t,
                frames=len(completions[t]),
                rate=1.0 / t_interval if t_interval > 0 else math.inf,
                interval=t_interval,
                latency=steady_mean(lat_sojourns.get(t, [])),
                bound_interval=max(tenant_load.get(t, {0: 0.0}).values()),
                busy=t_busy,
                utilization_share=(sum(t_busy.values()) / fleet_busy
                                   if fleet_busy > 0 else 0.0),
                injected_rate=None if rates is None else rates[t],
            )

        if self.mode == "periodic":
            total_busy = {p: 0.0 for p in busy_iv}
            for d in tenant_busy.values():
                for p, v in d.items():
                    total_busy[p] += v
        else:
            total_busy = {p: sum(iv[1] - iv[0] for iv in ivs)
                          for p, ivs in busy_iv.items()}
        # aggregate sojourn latency: completion-weighted tenant mean
        agg_latency = (
            sum(m.latency * max(m.frames, 1) for m in per_tenant.values())
            / max(sum(max(m.frames, 1) for m in per_tenant.values()), 1))
        res = SimResult(
            latency=agg_latency,
            latency_isolated=isolated,
            interval=interval,
            rate=1.0 / interval if interval > 0 else math.inf,
            makespan=makespan,
            frames=sum(len(c) for c in completions.values()),
            busy=total_busy,
            utilization=utilization,
            mean_utilization=sum(utilization.values()) / max(len(utilization), 1),
            per_frame_busy=per_frame_busy,
            bound_interval=bound,
            meta={"algorithm": assignment.algorithm, "in_flight": in_flight,
                  "tenants": tenants,
                  "latency_isolated_by_tenant": iso_by_tenant,
                  "rates": dict(rates) if rates else None},
            tenants=per_tenant,
        )
        self._run_memo_put(memo_key, res)
        return res
