"""Precompiled simulation contexts: the simulator's compiled core.

The discrete-event loop used to re-derive everything it needs from the
``Graph``/``CostModel`` objects on every call: predecessor/successor
dicts, per-node execution times (a ``CostModel.time`` call per event),
transfer costs, replica activity checks, and ``(stream, frame, node)``
tuple-keyed state dicts.  Profiling showed those lookups — not the heap
operations — dominating the loop.  A :class:`SimContext` hoists all of
it out of the hot path, once per (graph, cost model, stream structure):

* nodes renumbered to dense ``0..N-1`` indices in topological order,
* predecessor/successor adjacency as flat index tuples,
* bottom levels (the list-scheduling tiebreak) as a dense array,
* cross-PU transfer cost per producer node,
* replica round-robin activity precompiled per frame *phase*
  (``f % lcm(replica counts)``): per-phase missing-predecessor counts,
  initially-ready nodes, sink counts and active-successor lists,
* per-stream membership with the exact iteration orders the historical
  loop used (so event sequence numbers — and therefore results — are
  bit-identical).

Contexts are cached on the graph object itself (invalidated whenever
the graph mutates) and shared by every simulator instance built over
the same graph: the three measurement passes inside ``run()``, every
``lblp-r`` ``validate_rate`` probe, every ``ElasticSession`` event and
every benchmark sweep cell reuse one compiled structure.

Per-assignment state (which PU executes which node, at which speed) is
compiled separately into an :class:`ExecPlan` — per-node execution
times and per-edge transfer costs as dense arrays — and cached on the
context keyed by assignment identity, so repeated runs of the same
mapping (the common case) compile once.

Seeded (delta) builds for replica variants
------------------------------------------
``lblp-r`` probes dozens of replica variants of one base graph; each
variant is a fresh ``Graph`` object, so a from-scratch context build per
candidate would repeat the expensive parts verbatim.  Graphs derived by
replica-preserving transforms (``copy``/``replicate``/``drop_replica``,
and their composition ``with_replicas``) carry a link to their pristine
ancestor (``Graph.ctx_seed``); when that ancestor already has a context
under the same cache key, the variant's context is *seeded* from it:
bottom levels and execution/transfer cost tables are copied row-wise
(replica clones map onto their ``replica_group`` base row) instead of
recomputed — provably bit-identical, because those transforms change
neither any surviving node's cost nor its bottom level.  Replica phase
tables can't be copied (the phase period itself changes), but they are
*delta-built*: only nodes whose activity, predecessor counts or
successor lists actually vary across phases (replicas and their
neighbours) are recomputed per phase; everything else patches in from
phase-invariant base rows, and ``ExecPlan`` arrival rows alias one
tuple across all phases where the active-successor list is unchanged.

Quantized time grid ("periodic" mode)
-------------------------------------
``ExecPlan`` can quantize all costs onto an integer picosecond grid
(held in floats, exact below 2**53).  On that grid the closed-loop
simulator state provably recurs — enabling the exact-match steady-state
early exit in ``simulator.py`` — at the price of ~1e-6 relative
rounding on reported times versus the default exact mode.  For
multi-stream runs the fair-queueing virtual-time weights are quantized
too (:func:`quantize_stream_weights`): each stream's weight becomes an
integer whose ratios are small rationals, so virtual-time arithmetic is
exact and the joint state can recur at synchronized per-stream frame
shifts (see the simulator's module docstring).

The per-slot missing-predecessor vectors are additionally mirrored into
integer *digests* (base-B positional encoding with ``B`` > max
indegree, one big-int per slot, O(1) to update per arrival): digest
equality is exactly vector equality, which lets the steady-state
fingerprints compare slot progress without materializing an N-tuple per
slot per completion.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .cost import CostModel
from .graph import Graph

#: quantized-mode time grid: 1 tick = 1 picosecond.  Integer-valued
#: floats stay exact under +/max up to 2**53 ticks (~2.5 hours of
#: simulated time), far beyond any benchmark horizon.
TIME_SCALE = 1e12

#: replica phase tables are precompiled when the lcm of all replica
#: counts is at most this; beyond it the loop falls back to computing
#: activity per injection (identical results, just slower).
MAX_PHASE_PERIOD = 64

#: single bound for the shared per-context ``memo`` dict (measured_rate
#: probes, run() results, ...): every writer evicts LRU-style to this
MEMO_CAP = 512

#: max denominator when rationalizing multi-stream fair-queueing weight
#: ratios for the quantized grid.  Small denominators keep the joint
#: steady-state period short (the per-stream frame shifts of one period
#: are the rationalized numerators/denominators), at a worst-case
#: ~1/(2*16) ~ 3% perturbation of the weight *ratios* — comparable to
#: scheduling noise and far below the 5% tolerance the property tests
#: grant periodic mode.  Typical CNN mixes land well under 1%.
VT_MAX_DENOM = 16

#: give up on integer virtual-time weights (and therefore multi-stream
#: steady-state detection) when ``weight * frames`` could leave the
#: exact-float integer range.
_VT_MAX_SAFE = 2.0**52


def _phase_period(counts: Sequence[int]) -> int:
    out = 1
    for c in counts:
        if c > 1:
            out = out * c // math.gcd(out, c)
            if out > MAX_PHASE_PERIOD:
                return out
    return out


def quantize_stream_weights(weights: Sequence[float],
                            max_frames: int,
                            max_denom: int = VT_MAX_DENOM,
                            ) -> Optional[List[float]]:
    """Integer-valued virtual-time weights with small-rational ratios.

    Each weight ratio ``w_s / min(w)`` is replaced by its best rational
    approximation with denominator <= ``max_denom`` and all weights are
    rescaled onto the common denominator, so every weight is an exact
    integer (held in a float).  On these weights all virtual-time
    comparisons (``frame * weight``) are exact integer arithmetic below
    2**53, which makes the fair-queueing interleave *frame-shift
    invariant*: shifting every stream ``s`` by ``dF_s`` frames with
    ``dF_s * W_s`` equal across streams preserves every comparison —
    the property the multi-stream steady-state fingerprints rely on.

    Returns ``None`` when the integer weights could overflow the exact
    range for the requested frame budget (callers then keep the float
    weights and skip steady-state detection).
    """
    wmin = min(weights)
    if wmin <= 0:
        return None
    fracs = [Fraction(w / wmin).limit_denominator(max_denom) for w in weights]
    denom_lcm = 1
    for f in fracs:
        denom_lcm = denom_lcm * f.denominator // math.gcd(denom_lcm, f.denominator)
    ws = [f.numerator * (denom_lcm // f.denominator) for f in fracs]
    if max(ws) * max(max_frames, 1) > _VT_MAX_SAFE:
        return None
    return [float(w) for w in ws]


class ExecPlan:
    """Per-(context, assignment) compiled execution arrays."""

    __slots__ = ("pu_ids", "pu_index", "pu_of", "exec_t", "arrive", "quantized")

    def __init__(self, ctx: "SimContext", cm: CostModel, a, quantized: bool) -> None:
        g = ctx.graph
        self.quantized = quantized
        self.pu_ids: List[int] = [p.pu_id for p in a.pus]
        self.pu_index: Dict[int, int] = {pid: i for i, pid in enumerate(self.pu_ids)}
        specs = {p.pu_id: p for p in a.pus}

        # free nodes ride on any PU at zero cost; pin them to a successor's
        # (or predecessor's) PU so transfers are accounted sensibly — the
        # historical loop's rule, preserved verbatim (successors first,
        # earlier topo nodes pinned first, fleet head as last resort).
        pu_by_id = dict(a.mapping)
        for nid in ctx.ids:
            if nid not in pu_by_id:
                nbr = g.successors(nid) + g.predecessors(nid)
                pu_by_id[nid] = next(
                    (pu_by_id[m] for m in nbr if m in pu_by_id), a.pus[0].pu_id
                )
        self.pu_of: List[int] = [self.pu_index[pu_by_id[nid]] for nid in ctx.ids]

        # per-node execution times come from context-level tables keyed by
        # (pu_type, speed) — schedulers probing many candidate mappings
        # (lblp-x refine, lblp-r validation) rebuild plans often, and the
        # table lookup keeps that free of CostModel calls
        tables = {
            key: ctx.exec_table(spec.pu_type, spec.speed, quantized)
            for key, spec in specs.items()
        }
        pu_arr = [pu_by_id[nid] for nid in ctx.ids]
        self.exec_t: List[float] = [
            tables[pu_arr[j]][j] for j in range(ctx.n)
        ]

        # per phase, per node: (successor index, transfer cost) pairs for
        # the successors active at that phase (all of them when P == 1).
        # Nodes whose active-successor list is phase-invariant (the vast
        # majority under replication) share one row tuple across phases.
        xfer = ctx.xfer_table(quantized)
        pu_of = self.pu_of
        self.arrive: List[List[Tuple[Tuple[int, float], ...]]] = []
        n_phases = len(ctx.succs_by_phase)
        row_cache: List[Tuple[tuple, tuple]] = [None] * ctx.n  # (succs, row)
        for ph in range(n_phases):
            per_node = []
            succs_ph = ctx.succs_by_phase[ph]
            for j in range(ctx.n):
                succ = succs_ph[j]
                hit = row_cache[j]
                if hit is not None and hit[0] is succ:
                    per_node.append(hit[1])
                    continue
                cost = xfer[j]
                row = tuple(
                    (k, 0.0 if pu_of[k] == pu_of[j] else cost)
                    for k in succ
                )
                row_cache[j] = (succ, row)
                per_node.append(row)
            self.arrive.append(per_node)


class SimContext:
    """Dense-index compiled view of one (graph, cost model, streams)."""

    def __init__(self, graph: Graph, cm: CostModel,
                 structure: Tuple[List[str], Dict[str, List[int]],
                                  Dict[str, List[int]], Dict[str, List[int]],
                                  Dict[int, str]],
                 seed: Optional["SimContext"] = None) -> None:
        self.graph = graph
        streams, members, sources, sinks, stream_of = structure
        order = graph.topo_order()
        self.n = len(order)
        self.ids: Tuple[int, ...] = tuple(order)
        self.idx: Dict[int, int] = {nid: j for j, nid in enumerate(order)}
        idx = self.idx
        self.preds: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(idx[p] for p in graph.predecessors(nid)) for nid in order
        )
        self.succs: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(idx[s] for s in graph.successors(nid)) for nid in order
        )
        self.free: Tuple[bool, ...] = tuple(
            graph.nodes[nid].is_free() for nid in order
        )

        # map every node onto the seed context's dense index (replica
        # clones onto their replica_group base); a node the seed cannot
        # account for voids the whole seed (defensive: only
        # replica-preserving derivations set Graph._ctx_seed).
        self._seed = None
        self._seed_src: Optional[List[int]] = None
        if seed is not None:
            src = []
            for nid in order:
                base = nid if nid in seed.idx else \
                    graph.nodes[nid].meta.get("replica_group")
                if base is None or base not in seed.idx:
                    src = None
                    break
                src.append(seed.idx[base])
            if src is not None:
                self._seed = seed
                self._seed_src = src

        # bottom levels over native execution times (the historical
        # `_bottom_levels`, bit-identical float computation).  Seeded
        # builds copy the ancestor's values: a replica clone's bottom
        # level equals its base node's (same cost, same successors), and
        # no other node's changes (replicas never alter the max over a
        # predecessor's successor levels — the clone ties its base).
        if self._seed is not None:
            sbl = self._seed.blevel_by_id
            bl = {nid: sbl[nid if nid in sbl
                           else graph.nodes[nid].meta["replica_group"]]
                  for nid in order}
        else:
            bl = {}
            for nid in reversed(order):
                t = 0.0 if graph.nodes[nid].is_free() else cm.time(graph.nodes[nid])
                if math.isinf(t):
                    t = 0.0
                succ = graph.successors(nid)
                bl[nid] = t + max((bl[s] for s in succ), default=0.0)
        self.blevel_by_id = bl
        self.negbl: Tuple[float, ...] = tuple(-bl[nid] for nid in order)

        if self._seed is not None:
            sx = self._seed.xfer_cross
            self.xfer_cross = tuple(sx[s] for s in self._seed_src)
        else:
            self.xfer_cross = tuple(
                cm.transfer(graph.nodes[nid], same_pu=False) for nid in order
            )

        # replica round-robin tags
        rep_cnt = [graph.nodes[nid].replica_count for nid in order]
        rep_idx = [graph.nodes[nid].meta.get("replica_index", 0) for nid in order]
        self.rep_cnt, self.rep_idx = tuple(rep_cnt), tuple(rep_idx)
        self.replicated = any(c > 1 for c in rep_cnt)
        period = _phase_period(rep_cnt) if self.replicated else 1
        self.phases_compiled = period <= MAX_PHASE_PERIOD
        self.phase_period = period if self.phases_compiled else 1

        # streams (dense)
        self.stream_keys: List[str] = list(streams)
        self.members: List[List[int]] = [
            [idx[nid] for nid in members[s]] for s in streams
        ]
        self.sources: List[List[int]] = [
            [idx[nid] for nid in sources[s]] for s in streams
        ]
        self.n_sinks: List[int] = [len(sinks[s]) for s in streams]
        self.stream_of: List[int] = [0] * self.n
        skey = {s: i for i, s in enumerate(streams)}
        for nid, s in stream_of.items():
            self.stream_of[idx[nid]] = skey[s]

        # positional weights of the missing-vector digests: base-B with
        # B > max indegree, so digest equality <=> vector equality
        B = max((len(p) for p in self.preds), default=1) + 1
        pw = [1] * self.n
        for j in range(1, self.n):
            pw[j] = pw[j - 1] * B
        self.digest_pow: List[int] = pw

        self._compile_phases()
        self._cm = cm
        self._plans: Dict[Tuple[int, bool], Tuple[object, ExecPlan]] = {}
        self._exec_tables: Dict[tuple, Tuple[float, ...]] = {}
        self._xfer_tables: Dict[bool, Tuple[float, ...]] = {}
        #: scratch memo for derived deterministic figures (e.g. the
        #: measured_rate cache in schedulers.lblp_r), keyed by content
        self.memo: Dict[tuple, object] = {}

    # -- cost tables ---------------------------------------------------------
    def exec_table(self, pu_type, speed: float,
                   quantized: bool) -> Tuple[float, ...]:
        """Per-node execution times on a (pu_type, speed) unit; free
        nodes cost 0.  Quantized tables live on the integer tick grid.
        Seeded contexts copy the ancestor's rows instead of re-pricing."""
        key = (pu_type, speed, quantized)
        tab = self._exec_tables.get(key)
        if tab is None:
            if self._seed is not None:
                srow = self._seed.exec_table(pu_type, speed, quantized)
                tab = tuple(srow[s] for s in self._seed_src)
            else:
                g, cm = self.graph, self._cm
                raw = [
                    0.0 if g.nodes[nid].is_free()
                    else cm.time(g.nodes[nid], pu_type, speed)
                    for nid in self.ids
                ]
                if quantized:
                    raw = [t if t == math.inf else float(round(t * TIME_SCALE))
                           for t in raw]
                tab = tuple(raw)
            self._exec_tables[key] = tab
        return tab

    def xfer_table(self, quantized: bool) -> Tuple[float, ...]:
        """Cross-PU transfer cost per producer node."""
        tab = self._xfer_tables.get(quantized)
        if tab is None:
            raw = self.xfer_cross
            if quantized:
                raw = tuple(t if t == math.inf else float(round(t * TIME_SCALE))
                            for t in raw)
            tab = self._xfer_tables[quantized] = tuple(raw)
        return tab

    # -- replica phase tables ---------------------------------------------
    def active(self, j: int, f: int) -> bool:
        c = self.rep_cnt[j]
        return c == 1 or f % c == self.rep_idx[j]

    def _compile_phases(self) -> None:
        """Per-phase activity tables (phase = frame % lcm of replica
        counts): active-successor lists, per-stream initial missing
        counts, initially-ready nodes and sink counts — everything the
        historical per-frame ``inject``/``finish`` recomputed.

        Delta-built: only nodes whose activity, missing count, sink-ness
        or active-successor list actually varies with the phase (replicas
        and their graph neighbours) are recomputed per phase; the rest is
        patched in from phase-invariant base rows.  Content is identical
        to the straightforward per-phase recomputation (pinned by the
        property tests)."""
        P = self.phase_period
        if not self.phases_compiled:
            # dynamic fallback: single table with full successor lists;
            # the loop recomputes activity per injected frame instead
            self.succs_by_phase = [self.succs]
            self.base_missing = None
            self.init_ready = None
            self.phase_sinks = None
            self.base_digest = None
            return
        pw = self.digest_pow
        if not self.replicated:
            self.succs_by_phase = [self.succs]
            self.base_missing = [
                [[len(self.preds[j]) for j in range(self.n)]]
                for _ in self.stream_keys
            ]
            self.init_ready = [[list(src)] for src in self.sources]
            self.phase_sinks = [[c] for c in self.n_sinks]
            self.base_digest = [
                [sum(row[j] * pw[j] for j in range(self.n))]
                for row in (bm[0] for bm in self.base_missing)
            ]
            return

        rep = [self.rep_cnt[j] > 1 for j in range(self.n)]
        # phase-varying per aspect: own activity / missing count / succs
        var_act = rep
        var_miss = [rep[j] or any(rep[p] for p in self.preds[j])
                    for j in range(self.n)]
        var_succ = [any(rep[k] for k in self.succs[j]) for j in range(self.n)]

        self.succs_by_phase = []
        for ph in range(P):
            row = list(self.succs)
            for j in range(self.n):
                if var_succ[j]:
                    row[j] = tuple(k for k in self.succs[j]
                                   if self.active(k, ph))
            self.succs_by_phase.append(tuple(row))

        self.base_missing = []
        self.init_ready = []
        self.phase_sinks = []
        self.base_digest = []
        for s, _ in enumerate(self.stream_keys):
            mem = self.members[s]
            # phase-invariant member aspects
            stat_miss = [0] * self.n
            dyn_members = []          # members needing per-phase treatment
            stat_sinks = 0
            stat_ready = set()
            for j in mem:
                if var_act[j] or var_miss[j] or var_succ[j]:
                    dyn_members.append(j)
                    continue
                stat_miss[j] = len(self.preds[j])
                if not self.succs[j]:
                    stat_sinks += 1
                if not self.preds[j]:
                    stat_ready.add(j)
            base_row = stat_miss
            base_dig = sum(base_row[j] * pw[j] for j in mem)
            miss_by_phase, ready_by_phase = [], []
            sinks_by_phase, dig_by_phase = [], []
            for ph in range(P):
                miss = base_row[:]
                dig = base_dig
                sinks = stat_sinks
                dyn_ready = set()
                for j in dyn_members:
                    if not self.active(j, ph):
                        continue
                    m = sum(1 for p in self.preds[j] if self.active(p, ph))
                    miss[j] = m
                    dig += m * pw[j]
                    if not any(self.active(k, ph) for k in self.succs[j]):
                        sinks += 1
                    if m == 0:
                        dyn_ready.add(j)
                # member order matters: the historical loop pushed the
                # "ready" events in this exact iteration order
                ready = [j for j in mem
                         if j in stat_ready or j in dyn_ready]
                miss_by_phase.append(miss)
                ready_by_phase.append(ready)
                sinks_by_phase.append(sinks)
                dig_by_phase.append(dig)
            self.base_missing.append(miss_by_phase)
            self.init_ready.append(ready_by_phase)
            self.phase_sinks.append(sinks_by_phase)
            self.base_digest.append(dig_by_phase)

    # -- per-assignment plans ----------------------------------------------
    def plan(self, a, cm: CostModel, quantized: bool) -> ExecPlan:
        """Compiled execution arrays for ``a``; cached by identity so the
        passes of ``run()`` (and re-runs of a stored schedule) share one
        compilation."""
        key = (id(a), quantized)
        hit = self._plans.get(key)
        if hit is not None and hit[0] is a:
            return hit[1]
        if len(self._plans) >= 8:
            self._plans.clear()
        plan = ExecPlan(self, cm, a, quantized)
        self._plans[key] = (a, plan)
        return plan

    # -- cache -------------------------------------------------------------
    @staticmethod
    def for_graph(graph: Graph, cm: CostModel, kind: str,
                  structure_fn) -> "SimContext":
        """Fetch (or build) the context for ``graph`` under ``cm``.

        Cached on the graph object (cleared by ``Graph._invalidate`` on
        any mutation) keyed by the stream-structure kind and the cost
        model's calibration, so different hardware profiles and
        single-vs-multi-tenant views coexist.  A graph derived by a
        replica-preserving transform seeds its context from the
        ancestor's (same cache key) when one exists."""
        cache: Optional[dict] = getattr(graph, "_sim_contexts", None)
        if cache is None:
            cache = graph._sim_contexts = {}
        key = (kind, type(cm), cm.profile)
        ctx = cache.get(key)
        if ctx is None:
            seed = None
            seed_graph = graph.ctx_seed()
            if seed_graph is not None:
                seed = getattr(seed_graph, "_sim_contexts", {}).get(key)
            ctx = SimContext(graph, cm, structure_fn(), seed=seed)
            cache[key] = ctx
        return ctx
