"""Elastic rescheduling: PU failure -> LBLP re-placement on survivors.
The port's copy of ``repro.core.elastic``: its events and degradation
curves equal the reference's.

This is the paper's algorithm doing fleet-management duty: because LBLP
is fast (O(V log V + V*P)) and deterministic, the CDA can re-run it on
the surviving PU set the moment a PU drops, and reconfigure.  The same
policy drives the LM tier's stage re-partitioning when a device group is
lost (core.pipeline_partition).

Replica absorption (LRMP-style fast path)
-----------------------------------------
When the serving schedule carries layer replicas (``lblp-r``), a failed
PU whose every node is a replica with a surviving sibling does not need
a re-schedule at all: the dropped replicas' frames simply re-divide
round-robin over the survivors (``Graph.drop_replica``), the rest of
the mapping is untouched, and the fleet keeps serving at the amortized
degraded rate.  Only when a sole copy of some node dies does the
session fall back to a full re-schedule.  ``ElasticEvent.recovery``
records which path ran.

``ElasticSession`` tracks the live fleet, produces assignments, and
reports the degradation curve (rate/latency after each failure).

Serving verbs (tenant churn)
----------------------------
On a :class:`~repro_torch.core.graph.MultiTenantGraph`-backed session the
tenant set is no longer fixed at construction: ``add_tenant`` /
``remove_tenant`` mutate the union in place and re-co-schedule,
``reweight`` changes a tenant's serving priority (policy, not
structure: compiled contexts survive, the run memos key weights by
content), and ``set_replicas`` serves the union at explicit replica
widths through the ``lblp-r`` probe session.  Churn drops exactly the
session caches derived from the union (``_tenant_churn``) — the
serving control plane (``repro_torch.core.serving``) drives all of this
from a trace.

Simulation engine reuse
-----------------------
Every elastic event re-measures the fleet in the discrete-event
simulator.  The session holds one simulator per serving graph and the
compiled :class:`~repro_torch.core.simcontext.SimContext` (topo order, bottom
levels, adjacency, phase tables) is cached on the graph itself, so
repeated events over the same serving graph — the common case: every
``join``/reschedule serves the original graph object — re-derive
nothing.  ``engine`` selects the measurement engine (``"exact"``
default; ``"periodic"`` selects the quantized early-exit loop, see
``repro_torch.core.simulator``).

The incremental-probe layer compounds here: the scheduler's longest
paths are cached on the serving graph (``Graph.scratch``), replica
graphs produced by the absorb fast path seed their compiled context
from the pre-failure graph's (``drop_replica`` preserves bottom levels
and cost rows — see ``core.simcontext``), and ``run()`` results are
content-memoized per context, so a fleet that oscillates between
compositions (fail -> join -> fail of the same PU) re-measures known
states for free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import make_simulator
from .cost import CostModel, PUSpec
from .graph import Graph, MultiTenantGraph
from .schedulers import Assignment, get_scheduler
from .simulator import SimResult


@dataclass
class ElasticEvent:
    failed_pu: Optional[int]
    n_pus: int
    rate: float
    latency: float
    mapping: Dict[int, int]
    #: per-tenant steady-state rates when the session serves a
    #: MultiTenantGraph — one PU failure re-co-schedules *all* tenants.
    tenant_rates: Optional[Dict[str, float]] = None
    tenant_latencies: Optional[Dict[str, float]] = None
    #: what triggered the re-placement: "schedule" (PU fail/join re-run
    #: of the scheduler), "replica-absorb" (surviving replicas soaked up
    #: the failed PU), or the serving-tier verbs "tenant-add" /
    #: "tenant-remove" / "reweight" / "replicate" / "reclaim"
    recovery: str = "schedule"
    #: tenant the event concerned, for churn/reweight events
    tenant: Optional[str] = None
    #: the full simulator result behind rate/latency — retained on the
    #: *most recent* event only (older entries are thinned to the
    #: scalar fields above, or the append-only history would pin every
    #: busy-interval list ever measured); None over an empty union
    result: Optional[SimResult] = None


class ElasticSession:
    """Maintains a live node->PU mapping under PU failures."""

    def __init__(self, graph: Graph, pus: Sequence[PUSpec],
                 algorithm: Optional[str] = None,
                 cost_model: Optional[CostModel] = None,
                 engine: str = "exact", frames: int = 64) -> None:
        self.g = graph
        self.cm = cost_model or CostModel()
        self._multi = isinstance(graph, MultiTenantGraph)
        self.algorithm = algorithm or ("lblp-mt" if self._multi else "lblp")
        self.engine = engine
        #: frame budget of the per-event measurement runs
        self.frames = frames
        self.live: List[PUSpec] = list(pus)
        self.history: List[ElasticEvent] = []
        # one simulator per serving graph; its compiled SimContext is
        # additionally cached on the graph, so neither is rebuilt per event
        self._sims: Dict[int, tuple] = {}
        self._schedule(None)

    # -- internals -------------------------------------------------------
    def _schedule(self, failed: Optional[int], recovery: str = "schedule",
                  tenant: Optional[str] = None) -> None:
        if not self.live:
            raise RuntimeError("no surviving PUs")
        if not self.g.nodes:
            # an all-departed union: the fleet idles, nothing to place
            # or simulate (a session may be born empty and grow by
            # add_tenant, or churn down to zero tenants)
            self.serving_graph = self.g
            self.assignment = Assignment(
                mapping={}, pus=list(self.live), algorithm=self.algorithm)
            if self.history:
                self.history[-1].result = None   # see ElasticEvent.result
            self.history.append(ElasticEvent(
                failed_pu=failed, n_pus=len(self.live), rate=0.0,
                latency=0.0, mapping={},
                tenant_rates={} if self._multi else None,
                tenant_latencies={} if self._multi else None,
                recovery=recovery, tenant=tenant))
            return
        sched = get_scheduler(self.algorithm, self.cm)
        a: Assignment = sched.schedule(self.g, self.live)
        # graph-transforming schedulers (lblp-r) serve a derived graph
        serving = a.meta.get("replicated_graph", self.g)
        self._record(failed, serving, a, recovery=recovery, tenant=tenant)

    def _sim_for(self, serving: Graph):
        hit = self._sims.get(id(serving))
        if hit is not None and hit[0] is serving:
            return hit[1]
        if len(self._sims) >= 8:
            self._sims.clear()
        sim = make_simulator(serving, self.cm, engine=self.engine)
        self._sims[id(serving)] = (serving, sim)
        return sim

    def _record(self, failed: Optional[int], serving: Graph,
                a: Assignment, recovery: str,
                tenant: Optional[str] = None) -> None:
        self.serving_graph: Graph = serving
        self.assignment = a
        res: SimResult = self._sim_for(serving).run(a, frames=self.frames)
        if self.history:
            self.history[-1].result = None   # see ElasticEvent.result
        self.history.append(ElasticEvent(
            failed_pu=failed,
            n_pus=len(self.live),
            rate=res.rate,
            latency=res.latency,
            mapping=dict(a.mapping),
            tenant_rates=({t: m.rate for t, m in res.tenants.items()}
                          if res.tenants else None),
            tenant_latencies=({t: m.latency for t, m in res.tenants.items()}
                              if res.tenants else None),
            recovery=recovery,
            tenant=tenant,
            result=res,
        ))

    def _absorb(self, pu_id: int) -> bool:
        """Replica fast path: if every node on the failed PU is a replica
        with a surviving sibling, drop those replicas (their frames
        re-divide round-robin over the siblings) and keep the rest of the
        mapping untouched — no scheduler run."""
        a, g = self.assignment, self.serving_graph
        victims = [nid for nid, pid in a.mapping.items() if pid == pu_id]
        if not victims:
            return False
        groups = g.replica_groups()
        victim_set = set(victims)
        for nid in victims:
            grp = g.nodes[nid].replica_group
            if grp is None:
                return False
            if not any(m not in victim_set for m in groups[grp]):
                return False  # the whole group died with the PU
        g2 = g
        for nid in victims:
            g2 = g2.drop_replica(nid)
        survivors = [p for p in a.pus if p.pu_id != pu_id]
        new_a = Assignment(
            mapping={n: p for n, p in a.mapping.items() if n not in victim_set},
            pus=survivors,
            algorithm=a.algorithm,
            meta={**a.meta, "replicated_graph": g2,
                  "replicas": {b: len(ms)
                               for b, ms in g2.replica_groups().items()},
                  "absorbed_pu": pu_id, "dropped_replicas": sorted(victims)},
        )
        # the survivors' amortized load rose: refresh the derived figures
        # copied from the pre-failure schedule
        new_a.meta["bound_interval"] = max(new_a.load(g2, self.cm).values())
        new_a.meta["extra_replicas"] = sum(
            len(ms) - 1 for ms in g2.replica_groups().values())
        self._record(pu_id, g2, new_a, recovery="replica-absorb")
        return True

    # -- public API ------------------------------------------------------
    def fail(self, pu_id: int) -> ElasticEvent:
        """A PU died: absorb its load into surviving replicas if possible,
        otherwise reschedule everything it was running."""
        before = len(self.live)
        self.live = [p for p in self.live if p.pu_id != pu_id]
        if len(self.live) == before:
            raise KeyError(f"PU {pu_id} not in live set")
        if not self._absorb(pu_id):
            self._schedule(failed=pu_id)
        return self.history[-1]

    def join(self, pu: PUSpec,
             replicas: Optional[Dict[int, int]] = None) -> ElasticEvent:
        """A PU (re)joined the fleet: scale back up.  ``replicas``
        optionally re-applies replica widths in the same pass."""
        if any(p.pu_id == pu.pu_id for p in self.live):
            # all load/mapping accounting keys by pu_id; a duplicate
            # would silently double-book one physical unit
            raise KeyError(f"PU {pu.pu_id} is already in the live set")
        self.live.append(pu)
        if replicas and self.g.nodes:
            self._reschedule(replicas, recovery="schedule", tenant=None)
        else:
            self._schedule(failed=None)
        return self.history[-1]

    # -- tenant churn (serving tier) --------------------------------------
    def _union(self) -> MultiTenantGraph:
        if not self._multi:
            raise TypeError(
                "tenant churn needs a MultiTenantGraph-backed session")
        return self.g  # type: ignore[return-value]

    def _tenant_churn(self) -> None:
        """The union graph just mutated (tenant added/removed): drop
        exactly the session caches derived from it — the simulator held
        for the union itself and the ones for replica variants seeded
        from it.  Holding onto them is the stale-cache bug this guards
        against: ``_sim_for`` keys by graph *identity*, so after an
        in-place mutation it would keep handing back a simulator whose
        compiled context (and ``measured_rate``/``run`` memos) describe
        the pre-churn tenant set.  Graph-level caches (contexts,
        scratch, probe sessions) were already invalidated by
        ``Graph._invalidate`` inside the mutation."""
        self._sims = {
            k: v for k, v in self._sims.items()
            if v[0] is not self.g and v[0].ctx_seed() is not self.g
        }

    def add_tenant(self, graph: Graph, tenant: Optional[str] = None,
                   weight: float = 1.0,
                   replicas: Optional[Dict[int, int]] = None) -> ElasticEvent:
        """A tenant arrived: ingest its model graph into the served
        union (under serving weight ``weight``) and re-co-schedule.
        ``replicas`` optionally carries the replica widths to serve the
        new union at, so the replicated state is scheduled and measured
        directly instead of via a bare-union intermediate."""
        mt = self._union()
        t = mt.add_tenant(graph, tenant)
        if weight != 1.0:
            mt.set_tenant_weight(t, weight)
        self._tenant_churn()
        self._reschedule(replicas, recovery="tenant-add", tenant=t)
        return self.history[-1]

    def remove_tenant(self, tenant: str,
                      replicas: Optional[Dict[int, int]] = None
                      ) -> ElasticEvent:
        """A tenant departed: drop its component (and any replicas of
        its nodes) from the union and re-co-schedule the rest.
        ``replicas`` entries for departed nodes are filtered here."""
        mt = self._union()
        mt.remove_tenant(tenant)
        self._tenant_churn()
        self._reschedule(replicas, recovery="tenant-remove", tenant=tenant)
        return self.history[-1]

    def reweight(self, tenant: str, weight: float,
                 replicas: Optional[Dict[int, int]] = None) -> ElasticEvent:
        """Change a tenant's serving weight and re-co-schedule.  Weights
        are policy, not structure: compiled contexts and cached
        simulators stay valid (schedule and run memos key the weights
        by content), so this is the cheapest of the churn events."""
        mt = self._union()
        mt.set_tenant_weight(tenant, weight)
        self._reschedule(replicas, recovery="reweight", tenant=tenant)
        return self.history[-1]

    def adopt_union(self, union: MultiTenantGraph,
                    recovery: str = "tenant-add",
                    tenant: Optional[str] = None,
                    replicas: Optional[Dict[int, int]] = None
                    ) -> ElasticEvent:
        """Swap in an externally prepared union — e.g. an admission
        probe's candidate, content-identical to the served union plus
        the newcomer — as the served graph.  Unlike :meth:`add_tenant`
        this keeps the prepared graph's caches (compiled contexts,
        probe sessions, content-keyed run memos), so committing an
        already-probed state re-measures nothing."""
        if not isinstance(union, MultiTenantGraph):
            raise TypeError("adopt_union needs a MultiTenantGraph")
        self.g = union
        self._multi = True
        # every cached simulator belongs to the previous union's lineage
        self._sims.clear()
        self._reschedule(replicas, recovery=recovery, tenant=tenant)
        return self.history[-1]

    def _reschedule(self, replicas: Optional[Dict[int, int]],
                    recovery: str, tenant: Optional[str]) -> None:
        """Churn-verb scheduling: replicated when widths were handed in
        (and any survive the mutation), plain otherwise."""
        if replicas:
            replicas = {b: k for b, k in replicas.items()
                        if k > 1 and b in self.g.nodes}
        if replicas:
            self._schedule_replicated(replicas, recovery, tenant)
        else:
            self._schedule(None, recovery=recovery, tenant=tenant)

    # -- replica control (serving tier) -----------------------------------
    def set_replicas(self, counts: Dict[int, int],
                     recovery: str = "replicate") -> ElasticEvent:
        """Serve the union with the given replica widths (base node id
        -> total count; entries of 1 are no-ops, ``{}`` reclaims every
        replica).  Runs through the ``lblp-r`` probe session cached on
        the union, so repeated visits to one replica signature — the
        serving control loop's common case — share a single derived
        graph, inner schedule, seeded simulation context and run memo."""
        self._schedule_replicated(
            {b: k for b, k in counts.items() if k > 1}, recovery, None)
        return self.history[-1]

    def _schedule_replicated(self, counts: Dict[int, int], recovery: str,
                             tenant: Optional[str]) -> None:
        if self.algorithm == "lblp-r":
            raise ValueError(
                "set_replicas drives replication explicitly; use an inner "
                "algorithm (lblp/lblp-mt) for the session, not lblp-r")
        from .schedulers.lblp_r import ProbeSession
        sched = get_scheduler(self.algorithm, self.cm)
        sess = ProbeSession.for_graph(self.g, self.cm, self.live, sched)
        e = sess.probe(counts)
        serving, inner_a = e["graph"], e["assignment"]
        # fresh Assignment: probe entries are shared cache objects
        a = Assignment(
            mapping=dict(inner_a.mapping),
            pus=list(self.live),
            algorithm=inner_a.algorithm,
            meta={**inner_a.meta,
                  "replicas": dict(counts),
                  "replicated_graph": serving,
                  "extra_replicas": sum(k - 1 for k in counts.values()),
                  "bound_interval": (max(e["load"].values())
                                     if e["load"] else 0.0)},
        )
        self._record(None, serving, a, recovery=recovery, tenant=tenant)

    def replica_counts(self) -> Dict[int, int]:
        """Replica widths of the currently served graph (base node id ->
        count), as maintained by set_replicas / lblp-r / absorb events."""
        return {b: len(ms)
                for b, ms in self.serving_graph.replica_groups().items()}

    def degradation_curve(self) -> List[Tuple[int, float, float]]:
        return [(e.n_pus, e.rate, e.latency) for e in self.history]
