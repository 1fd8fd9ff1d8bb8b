"""Serving control plane: SLO-aware admission control, tenant churn and
replica autoscaling over the IMCE fleet.  The port's copy of
``repro.core.serving``: ``audit_json`` is string-equal to the reference's
on the same trace, under either engine.

The paper deploys a *fixed* set of CNN graphs; a production fleet faces
*changing* traffic — tenants arrive with service promises, depart, get
re-prioritized, and PUs fail and rejoin underneath them.  This module
is the deterministic, trace-driven control loop above the pieces the
earlier tiers provide:

* **admission control** — an arriving tenant (model graph + SLO: a
  minimum processing rate and/or a maximum streaming sojourn latency)
  is *probed* before it is admitted: the candidate co-schedule (union +
  newcomer, current replica widths) is placed by ``lblp-mt`` and
  measured in the discrete-event simulator; the tenant is admitted only
  if every admitted tenant's SLO — and its own — would still be met.
* **reclaim** — before rejecting, the plane retries the probe with all
  layer replicas reclaimed: elasticity spent on throughput for the
  already-admitted is returned when the capacity is needed to honor a
  new promise (autoscaling re-adds whatever still fits afterwards).
* **replica autoscaling** — free capacity is spent on the *hottest*
  admitted tenant (the one with least SLO headroom): its bottleneck
  layers are widened LRMP-style through the ``lblp-r`` probe sessions,
  with the transfer-aware analytic gain model pruning hopeless
  candidates before any simulation.
* **repair / eviction** — a PU failure (or reweight) can make the
  admitted set infeasible through no admission mistake; the plane then
  sheds the lightest-weight, most-recently-admitted tenants until every
  surviving promise holds again.  With repair on, *no admitted tenant
  ever samples a violated SLO* — violations only appear in the reports
  of baselines that skip admission (``admission=False``).

Everything is deterministic: the same trace and fleet produce a
bit-identical decision log and SLO reports per simulation engine
(``tests/test_torch_elastic_serving.py`` holds the port's logs equal to
the reference's), so the log is an audit trail, not a telemetry
sample.  The loop stays incremental through the cache
layers underneath: replica probes share one derived graph + inner
schedule + seeded ``SimContext`` per replica signature
(``Graph.scratch`` probe sessions), repeated visits to a serving state
hit the content-keyed run memo, and tenant churn invalidates exactly
the union-derived caches (``ElasticSession._tenant_churn``).

Trace file format
-----------------
A trace is a JSON array of event objects, one per control tick::

    [{"kind": "arrive", "tenant": "cam-0", "model": "resnet8",
      "slo": {"min_rate": 400.0, "max_latency": 0.25}, "weight": 1.0},
     {"kind": "load",   "tenant": "cam-0", "weight": 2.0},
     {"kind": "fail",   "pu_id": 3},
     {"kind": "join",   "pu_id": 3, "pu_type": "imc", "speed": 1.0},
     {"kind": "depart", "tenant": "cam-0"}]

``kind`` is one of ``arrive`` / ``depart`` / ``load`` (weight change) /
``fail`` / ``join``.  ``model`` names an entry of the model registry
handed to :class:`ServingControlPlane`; ``slo`` may promise either or
both dimensions.  :func:`load_trace` / :func:`dump_trace` round-trip
the format.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import make_simulator
from .cost import CostModel, PUSpec
from .elastic import ElasticSession
from .graph import Graph, GraphError, MultiTenantGraph, PUType
from .schedulers import get_scheduler
from .schedulers.lblp_r import ProbeSession, replication_candidates
from .simulator import SimResult, slo_headroom


@dataclass(frozen=True)
class SLO:
    """A tenant's service promise: a minimum steady-state processing
    rate [frames/s] and/or a maximum streaming sojourn latency [s]."""

    min_rate: Optional[float] = None
    max_latency: Optional[float] = None

    def headroom(self, rate: float, latency: float) -> float:
        """Signed relative margin of attained figures to this promise —
        the same formula as :meth:`TenantMetrics.slo_headroom`, for
        callers holding raw figures instead of a metrics object."""
        return slo_headroom(rate, latency, self.min_rate, self.max_latency)

    def to_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, raw: Optional[dict]) -> "SLO":
        raw = raw or {}
        return cls(min_rate=raw.get("min_rate"),
                   max_latency=raw.get("max_latency"))


@dataclass(frozen=True)
class TraceEvent:
    """One tick of the serving trace (see module docstring)."""

    kind: str                       # arrive | depart | load | fail | join
    tenant: Optional[str] = None
    model: Optional[str] = None     # arrive: model-registry key
    slo: SLO = SLO()
    weight: float = 1.0             # arrive / load: serving weight
    pu_id: Optional[int] = None     # fail / join
    pu_type: Optional[str] = None   # join: "imc" | "dpu"
    speed: float = 1.0              # join

    def label(self) -> str:
        tgt = self.tenant if self.tenant is not None else self.pu_id
        return f"{self.kind}({tgt})"

    def to_dict(self) -> dict:
        out: dict = {"kind": self.kind}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.model is not None:
            out["model"] = self.model
        if self.slo != SLO():
            out["slo"] = self.slo.to_dict()
        if self.kind in ("arrive", "load"):
            out["weight"] = self.weight
        if self.pu_id is not None:
            out["pu_id"] = self.pu_id
        if self.pu_type is not None:
            out["pu_type"] = self.pu_type
        if self.kind == "join":
            out["speed"] = self.speed
        return out


def load_trace(text: str) -> List[TraceEvent]:
    """Parse the JSON trace format into :class:`TraceEvent` objects."""
    events = []
    for raw in json.loads(text):
        events.append(TraceEvent(
            kind=raw["kind"],
            tenant=raw.get("tenant"),
            model=raw.get("model"),
            slo=SLO.from_dict(raw.get("slo")),
            weight=raw.get("weight", 1.0),
            pu_id=raw.get("pu_id"),
            pu_type=raw.get("pu_type"),
            speed=raw.get("speed", 1.0),
        ))
    return events


def dump_trace(events: Sequence[TraceEvent]) -> str:
    return json.dumps([e.to_dict() for e in events], indent=2)


@dataclass
class Decision:
    """One auditable control-plane action.  A single trace event can
    yield several decisions (e.g. ``reclaim`` then ``admit`` then
    ``replicate``); ``index`` ties them back to the trace tick."""

    index: int                      # trace event index
    event: str                      # TraceEvent.label() of the trigger
    action: str                     # admit | reject | depart | load |
                                    # fail | join | replicate | reclaim |
                                    # evict
    tenant: Optional[str]
    reason: str
    admitted: List[str]             # tenant set after the action
    replicas: Dict[int, int]        # replica widths after the action
    rates: Dict[str, float]         # per-tenant attained rate [fps]
    latencies: Dict[str, float]     # per-tenant sojourn latency [s]
    headroom: Dict[str, float]      # per-tenant SLO headroom (signed)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["replicas"] = {str(k): v for k, v in self.replicas.items()}
        # strict JSON: an unbounded headroom (nothing promised) is null,
        # never the non-standard Infinity token
        d["headroom"] = {t: (None if math.isinf(h) else h)
                         for t, h in self.headroom.items()}
        return d


@dataclass
class SLOReport:
    """Per-tenant audit: the promise, what was attained at every trace
    tick the tenant was admitted for, and the violation intervals."""

    tenant: str
    slo: SLO
    weight: float
    admitted_index: Optional[int] = None
    departed_index: Optional[int] = None
    rejected_index: Optional[int] = None
    evicted_index: Optional[int] = None
    #: (trace index, attained rate, attained latency, SLO headroom)
    samples: List[Tuple[int, float, float, float]] = field(default_factory=list)

    @property
    def violations(self) -> List[Tuple[int, int]]:
        """Inclusive trace-index intervals where the SLO was broken."""
        out: List[Tuple[int, int]] = []
        for idx, _r, _l, h in self.samples:
            if h >= 0.0:
                continue
            if out and out[-1][1] == idx - 1:
                out[-1] = (out[-1][0], idx)
            else:
                out.append((idx, idx))
        return out

    def satisfied(self) -> bool:
        """True iff the tenant was admitted and never sampled below its
        promise while resident."""
        return self.admitted_index is not None and not self.violations

    def to_dict(self) -> dict:
        d = asdict(self)
        d["slo"] = self.slo.to_dict()
        # strict JSON: clamp unbounded headrooms (see Decision.to_dict)
        d["samples"] = [[i, r, lat, None if math.isinf(h) else h]
                        for (i, r, lat, h) in self.samples]
        d["violations"] = [list(v) for v in self.violations]
        d["satisfied"] = self.satisfied()
        return d


def aggregate_goodput(reports: Dict[str, SLOReport],
                      n_events: int) -> Tuple[List[float], float]:
    """Per-trace-tick goodput and its mean over the whole trace.

    Goodput counts a tenant's attained rate only while its SLO holds: a
    violated promise delivers zero value to its owner, which is what
    separates SLO-aware admission from admit-all over-subscription."""
    per_tick = [0.0] * n_events
    for rep in reports.values():
        for idx, rate, _lat, h in rep.samples:
            if h >= 0.0:
                per_tick[idx] += rate
    mean = sum(per_tick) / n_events if n_events else 0.0
    return per_tick, mean


class ServingControlPlane:
    """Trace-driven SLO-aware serving loop over one PU fleet.

    Parameters
    ----------
    pus:        the initial fleet.
    models:     model registry: ``arrive`` events reference graphs by
                key.  Graph objects may be shared across planes — they
                are never mutated (the union ingests copies of their
                node data).
    engine:     simulation engine for every probe and measurement
                (``"periodic"`` recommended: the control loop is
                exactly the cheap-what-if regime it was built for).
    frames:     per-stream frame budget of each measurement.
    admission:  gate arrivals on the SLO probe (False = admit-all
                baseline; violations then show up in the reports).
    autoscale:  spend free capacity on replica widening.
    replica_budget: max extra replicas resident at once (None -> fleet
                size, matching ``lblp-r``).
    min_headroom: required relative SLO margin for admission and
                autoscale acceptance (0.0 = meet exactly).
    """

    #: bottleneck-layer candidates probed per autoscale pass
    AUTOSCALE_CANDIDATES = 4

    def __init__(self, pus: Sequence[PUSpec], models: Dict[str, Graph],
                 cost_model: Optional[CostModel] = None,
                 engine: str = "periodic", frames: int = 64,
                 admission: bool = True, autoscale: bool = True,
                 replica_budget: Optional[int] = None,
                 min_headroom: float = 0.0) -> None:
        self.models = dict(models)
        self.cm = cost_model or CostModel()
        self.engine = engine
        self.frames = frames
        self.admission = admission
        self.autoscale = autoscale
        self.replica_budget = replica_budget
        self.min_headroom = min_headroom
        self.union = MultiTenantGraph("serving")
        self.session = ElasticSession(
            self.union, pus, algorithm="lblp-mt", cost_model=self.cm,
            engine=engine, frames=frames)
        self.slos: Dict[str, SLO] = {}
        self.weights: Dict[str, float] = {}
        self.replicas: Dict[int, int] = {}
        self.decisions: List[Decision] = []
        self.reports: Dict[str, SLOReport] = {}
        self.n_events = 0
        #: what-if schedule+simulate probes issued (admission + autoscale)
        self.probes = 0

    # -- trace playback ---------------------------------------------------
    def play(self, trace: Sequence[TraceEvent]) -> List[Decision]:
        for ev in trace:
            self.step(ev)
        return self.decisions

    def step(self, ev: TraceEvent) -> None:
        index = self.n_events
        self.n_events += 1
        handler = {
            "arrive": self._on_arrive, "depart": self._on_depart,
            "load": self._on_load, "fail": self._on_fail,
            "join": self._on_join,
        }.get(ev.kind)
        if handler is None:
            raise ValueError(f"unknown trace event kind {ev.kind!r}")
        handler(index, ev)
        self._sample(index)

    # -- event handlers ---------------------------------------------------
    def _on_arrive(self, index: int, ev: TraceEvent) -> None:
        tenant, model = ev.tenant, ev.model
        if tenant is None or model is None:
            raise ValueError("arrive events need tenant and model")
        if tenant in self.reports:
            raise GraphError(f"tenant name '{tenant}' already used")
        g = self.models[model]
        rep = self.reports[tenant] = SLOReport(
            tenant=tenant, slo=ev.slo, weight=ev.weight)
        if not self.admission:
            self._commit_arrival(index, ev, g,
                                 reason="admission control disabled")
            return
        # one candidate union serves both probes (shared probe session,
        # shared compiled context)
        cand = self._candidate_union(g, tenant, ev.weight)
        # probe 1: candidate union under the current replica widths
        res = self._probe_arrival(g, tenant, ev.weight, self.replicas,
                                  cand=cand)
        heads = self._headrooms(res, extra={tenant: ev.slo})
        if self._feasible(heads):
            self._commit_arrival(index, ev, g,
                                 reason=self._headroom_reason(heads),
                                 cand=cand)
            return
        if self.replicas:
            # probe 2: reclaim every replica to make room
            res2 = self._probe_arrival(g, tenant, ev.weight, {}, cand=cand)
            heads2 = self._headrooms(res2, extra={tenant: ev.slo})
            if self._feasible(heads2):
                self.replicas = {}
                self._decide(index, ev, "reclaim", None,
                             "replicas reclaimed to admit "
                             f"'{tenant}'")
                self._commit_arrival(index, ev, g,
                                     reason=self._headroom_reason(heads2),
                                     cand=cand)
                return
            heads = heads2
        rep.rejected_index = index
        self._decide(index, ev, "reject", tenant,
                     "would break SLOs: " + self._headroom_reason(heads))

    def _commit_arrival(self, index: int, ev: TraceEvent, g: Graph,
                        reason: str,
                        cand: Optional[MultiTenantGraph] = None) -> None:
        tenant = ev.tenant
        if cand is not None:
            # commit the probed candidate itself: its probe session and
            # content-keyed run memo make the re-measurement free
            self.session.adopt_union(cand, recovery="tenant-add",
                                     tenant=tenant, replicas=self.replicas)
            self.union = cand
        else:
            self.session.add_tenant(g, tenant, weight=ev.weight,
                                    replicas=self.replicas)
        self.slos[tenant] = ev.slo
        self.weights[tenant] = ev.weight
        self.reports[tenant].admitted_index = index
        self._reconcile(index, ev)
        self._decide(index, ev, "admit", tenant, reason)
        self._autoscale(index, ev)

    def _on_depart(self, index: int, ev: TraceEvent) -> None:
        tenant = self._resident(index, ev)
        if tenant is None:
            return
        self.session.remove_tenant(tenant, replicas=self.replicas)
        self.slos.pop(tenant)
        self.weights.pop(tenant)
        self.reports[tenant].departed_index = index
        self._reconcile(index, ev)
        self._decide(index, ev, "depart", tenant, "tenant departed")
        self._repair(index, ev)
        self._autoscale(index, ev)

    def _on_load(self, index: int, ev: TraceEvent) -> None:
        tenant = self._resident(index, ev)
        if tenant is None:
            return
        self.session.reweight(tenant, ev.weight, replicas=self.replicas)
        self.weights[tenant] = ev.weight
        self.reports[tenant].weight = ev.weight
        self._reconcile(index, ev)
        self._decide(index, ev, "load", tenant,
                     f"serving weight -> {ev.weight:g}")
        self._repair(index, ev)
        self._autoscale(index, ev)

    def _on_fail(self, index: int, ev: TraceEvent) -> None:
        e = self.session.fail(ev.pu_id)
        # a replica-absorb recovery narrowed groups under us
        self.replicas = self.session.replica_counts()
        self._reconcile(index, ev)
        self._decide(index, ev, "fail", None,
                     f"PU {ev.pu_id} failed ({e.recovery})")
        self._repair(index, ev)
        self._autoscale(index, ev)

    def _on_join(self, index: int, ev: TraceEvent) -> None:
        if ev.pu_id is None or ev.pu_type is None:
            raise ValueError("join events need pu_id and pu_type")
        pu = PUSpec(pu_id=ev.pu_id, pu_type=PUType(ev.pu_type),
                    speed=ev.speed)
        self.session.join(pu, replicas=self.replicas)
        self._reconcile(index, ev)
        self._decide(index, ev, "join", None, f"PU {ev.pu_id} joined")
        self._repair(index, ev)
        self._autoscale(index, ev)

    def _resident(self, index: int, ev: TraceEvent) -> Optional[str]:
        """Traces are policy-independent: an event for a tenant this
        plane rejected (or already evicted) is a recorded no-op, so one
        trace replays identically against different policies."""
        t = ev.tenant
        if t in self.slos:
            return t
        self._decide(index, ev, "noop", t, f"'{t}' is not resident")
        return None

    # -- control actions --------------------------------------------------
    def _reconcile(self, index: int, ev: TraceEvent) -> None:
        """Bring the served schedule back to the desired replica widths
        after a structural event.  The churn verbs are handed the
        widths and schedule the replicated state directly, so this is
        normally a no-op check; it still fires after a full-reschedule
        failover (widths dropped) or when departures orphaned entries."""
        self.replicas = {b: k for b, k in self.replicas.items()
                         if b in self.union.nodes}
        if self.session.replica_counts() != self.replicas:
            self.session.set_replicas(self.replicas)

    def _repair(self, index: int, ev: TraceEvent) -> None:
        """Restore feasibility after capacity loss (see class doc):
        first return the elasticity — reclaim every replica, exactly
        like the admission path does before rejecting — and only then
        evict, lightest serving weight first, then most recently
        admitted, then name: the cheapest promises to break when
        capacity is lost through no admission mistake."""
        if not self.admission:
            return
        if (self.slos and self.replicas
                and not self._feasible(self._headrooms(self._result()))):
            self.replicas = {}
            self.session.set_replicas({}, recovery="reclaim")
            self._decide(index, ev, "reclaim", None,
                         "SLO repair: replicas reclaimed before eviction")
        while self.slos:
            heads = self._headrooms(self._result())
            if self._feasible(heads):
                return
            victim = min(
                self.slos,
                key=lambda t: (self.weights[t],
                               -self.reports[t].admitted_index, t))
            self.session.remove_tenant(victim)
            self.slos.pop(victim)
            self.weights.pop(victim)
            self.reports[victim].evicted_index = index
            self._reconcile(index, ev)
            self._decide(index, ev, "evict", victim,
                         "SLO repair: " + self._headroom_reason(heads))

    def _autoscale(self, index: int, ev: TraceEvent) -> None:
        """Spend free capacity on the hottest admitted tenant: widen its
        bottleneck layers while every SLO keeps its margin and the hot
        tenant's rate actually improves.  Candidates are pruned by the
        transfer-aware analytic gain model before any probe."""
        if not self.autoscale or not self.slos:
            return
        budget = (self.replica_budget if self.replica_budget is not None
                  else len(self.session.live))
        while sum(k - 1 for k in self.replicas.values()) < budget:
            res = self._result()
            heads = self._headrooms(res)
            hot = min(self.slos,
                      key=lambda t: (heads[t],
                                     -res.tenants[t].utilization_share, t))
            accepted = False
            for base, k_new in self._bottleneck_candidates(hot):
                try_counts = {**self.replicas, base: k_new}
                probe = self._evaluate(self.union, try_counts)
                heads2 = self._headrooms(probe)
                if (self._feasible(heads2)
                        and probe.tenants[hot].rate
                        > res.tenants[hot].rate * 1.001):
                    self.replicas = try_counts
                    self.session.set_replicas(try_counts)
                    self._decide(
                        index, ev, "replicate", hot,
                        f"widened node {base} -> {k_new} for hottest "
                        f"tenant '{hot}'")
                    accepted = True
                    break
            if not accepted:
                return

    def _bottleneck_candidates(self, tenant: str
                               ) -> List[Tuple[int, int]]:
        """The hottest tenant's bottleneck layers: its nodes on the PU
        carrying its largest per-frame load, enumerated by the same
        :func:`~repro_torch.core.schedulers.lblp_r.replication_candidates`
        loop the lblp-r search uses (heaviest amortized first,
        sub-fleet width cap, ``estimated_gain`` pruning), capped at
        :data:`AUTOSCALE_CANDIDATES` probes."""
        a = self.session.assignment
        sg = self.session.serving_graph
        tload = a.tenant_load(sg, self.cm).get(tenant)
        if not tload:
            return []
        cands, _ = replication_candidates(
            sg, a, a.load(sg, self.cm), self.cm, self.session.live,
            self.replicas,
            pu=max(tload, key=lambda p: (tload[p], -p)),
            node_filter=lambda n: n.meta.get("tenant") == tenant,
            limit=self.AUTOSCALE_CANDIDATES)
        return cands

    # -- probes / evaluation ----------------------------------------------
    def _candidate_union(self, g: Graph, tenant: str,
                         weight: float) -> MultiTenantGraph:
        cand = self.union.copy()
        cand.add_tenant(g, tenant)
        if weight != 1.0:
            cand.set_tenant_weight(tenant, weight)
        return cand

    def _probe_arrival(self, g: Graph, tenant: str, weight: float,
                       counts: Dict[int, int],
                       cand: Optional[MultiTenantGraph] = None) -> SimResult:
        """What-if: the union plus the candidate tenant under ``counts``
        replica widths, scheduled and measured without committing.
        Pass ``cand`` to probe one candidate union at several replica
        signatures (shared probe session and compiled context)."""
        if cand is None:
            cand = self._candidate_union(g, tenant, weight)
        return self._evaluate(cand, counts)

    def _evaluate(self, union: MultiTenantGraph,
                  counts: Dict[int, int]) -> SimResult:
        sched = get_scheduler(self.session.algorithm, self.cm)
        sess = ProbeSession.for_graph(union, self.cm, self.session.live,
                                       sched)
        e = sess.probe({b: k for b, k in counts.items() if k > 1})
        sim = make_simulator(e["graph"], self.cm, engine=self.engine)
        self.probes += 1
        return sim.run(e["assignment"], frames=self.frames)

    def _result(self) -> SimResult:
        res = self.session.history[-1].result
        if res is None:
            raise RuntimeError("no serving state to evaluate")
        return res

    def _headrooms(self, res: SimResult,
                   extra: Optional[Dict[str, SLO]] = None
                   ) -> Dict[str, float]:
        slos = dict(self.slos)
        if extra:
            slos.update(extra)
        return {t: res.tenants[t].slo_headroom(s.min_rate, s.max_latency)
                for t, s in slos.items() if t in res.tenants}

    def _feasible(self, heads: Dict[str, float]) -> bool:
        return all(h >= self.min_headroom for h in heads.values())

    @staticmethod
    def _headroom_reason(heads: Dict[str, float]) -> str:
        worst = sorted(heads.items(), key=lambda kv: kv[1])[:3]
        body = ", ".join(f"{t}={h:+.3f}" for t, h in worst)
        return f"min headroom [{body}]" if body else "no admitted tenants"

    # -- bookkeeping ------------------------------------------------------
    def _decide(self, index: int, ev: TraceEvent, action: str,
                tenant: Optional[str], reason: str) -> None:
        last = self.session.history[-1]
        res = last.result
        self.decisions.append(Decision(
            index=index,
            event=ev.label(),
            action=action,
            tenant=tenant,
            reason=reason,
            admitted=list(self.union.tenants),
            replicas=dict(self.replicas),
            rates=dict(last.tenant_rates or {}),
            latencies=dict(last.tenant_latencies or {}),
            headroom=self._headrooms(res) if res is not None else {},
        ))

    def _sample(self, index: int) -> None:
        if not self.slos:
            return
        res = self._result()
        for t, slo in self.slos.items():
            m = res.tenants[t]
            self.reports[t].samples.append(
                (index, m.rate, m.latency,
                 m.slo_headroom(slo.min_rate, slo.max_latency)))

    # -- audit artifacts --------------------------------------------------
    def decision_log(self) -> List[dict]:
        return [d.to_dict() for d in self.decisions]

    def slo_reports(self) -> Dict[str, dict]:
        return {t: r.to_dict() for t, r in sorted(self.reports.items())}

    def audit_json(self) -> str:
        """The full audit artifact, canonically serialized — equality of
        two of these is the determinism contract."""
        per_tick, mean = aggregate_goodput(self.reports, self.n_events)
        return json.dumps({
            "decisions": self.decision_log(),
            "reports": self.slo_reports(),
            "goodput_per_tick": per_tick,
            "goodput_mean": mean,
            "events": self.n_events,
            "probes": self.probes,
        }, indent=2, sort_keys=True)
