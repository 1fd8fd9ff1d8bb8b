"""DAG intermediate representation for neural-network deployment graphs.

This is the paper's object of study: a CNN (or any DNN) is a directed
acyclic graph of *nodes* (fused operator groups, e.g. ``Conv+ReLU``) that
must be mapped onto a set of processing units.  The scheduler tier
(``repro_torch.core.schedulers``) consumes this IR; the simulator
(``repro_torch.core.simulator``) executes mappings over it.  This is the
port's copy of ``repro.core.graph``: ``to_json`` is byte-equal to the
reference's.

Design notes
------------
* Node ids are 1-based integers to match the paper's Table I convention.
* ``OpKind`` distinguishes the functional class of every node; the *PU
  compatibility* of a node is derived from its kind (conv/MVM -> IMC,
  everything else -> DPU) exactly as described in §IV of the paper, but can
  be overridden per-node (``Node.pu_type``) for what-if studies.
* Longest path / levels / ancestor queries are pre-computed lazily and
  cached; all algorithms here are O(V+E) except ancestor bitsets which are
  O(V*E/64) — trivial for the paper's graphs (<= 233 nodes).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


class PUType(enum.Enum):
    """Processing-unit class of the hybrid IMC device (paper §III)."""

    IMC = "imc"
    DPU = "dpu"


class OpKind(enum.Enum):
    """Functional class of a graph node.

    ``CONV``/``MVM`` are the in-memory-computable kinds; the rest are
    digital ops served by DPUs (paper §IV, first paragraph).
    Activations (ReLU/SiLU) are *fused* into their producer conv/MVM, as
    in the IMCE PUs ("optionally followed by activation functions").
    """

    CONV = "conv"
    MVM = "mvm"                 # fully-connected / matmul
    ADD = "add"
    MUL = "mul"
    POOL_MAX = "pool_max"
    POOL_AVG = "pool_avg"
    GLOBAL_POOL = "global_pool"
    CONCAT = "concat"
    SPLIT = "split"
    RESHAPE = "reshape"
    UPSAMPLE = "upsample"
    SOFTMAX = "softmax"
    ACT = "act"                 # standalone activation (not fused)
    INPUT = "input"
    OUTPUT = "output"
    # LM-tier kinds (used by core.pipeline_partition over transformer DAGs)
    ATTENTION = "attention"
    MOE = "moe"
    RECURRENT = "recurrent"
    EMBED = "embed"
    NORM = "norm"


#: op kinds that the IMC PUs execute natively (weight-stationary MVM class).
IMC_KINDS = frozenset(
    {OpKind.CONV, OpKind.MVM, OpKind.ATTENTION, OpKind.MOE, OpKind.EMBED}
)

#: zero-cost structural kinds (graph glue; the IMCE runtime folds these).
FREE_KINDS = frozenset({OpKind.INPUT, OpKind.OUTPUT})


def default_pu_type(kind: OpKind) -> PUType:
    """Paper §IV: conv/MVM -> IMC, every other function -> DPU."""
    return PUType.IMC if kind in IMC_KINDS else PUType.DPU


@dataclass
class Node:
    """One deployable node of the network graph.

    Attributes
    ----------
    node_id:   1-based unique id (paper Table I numbering).
    name:      human-readable name (e.g. ``layer2.0.conv1+relu``).
    kind:      functional class; determines PU compatibility.
    flops:     MAC-equivalent floating/fixed op count of the node.
    weight_bytes: stationary parameter footprint (INT8 bytes) — the IMC
               crossbar area the node occupies (paper Table I "Weights
               Area").  Zero for DPU ops.
    out_bytes: activation bytes forwarded to consumers (INT8).
    out_elems: number of output elements (drives DPU cost).
    pu_type:   which PU class executes this node (derived from kind unless
               overridden).
    fused_act: activation fused into this node ("relu"/"silu"/None).
    meta:      free-form dict (shapes, layer indices, ...).
    """

    node_id: int
    name: str
    kind: OpKind
    flops: float = 0.0
    weight_bytes: float = 0.0
    out_bytes: float = 0.0
    out_elems: float = 0.0
    pu_type: Optional[PUType] = None
    fused_act: Optional[str] = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.pu_type is None:
            self.pu_type = default_pu_type(self.kind)

    def is_free(self) -> bool:
        return self.kind in FREE_KINDS

    # -- replication (LRMP-style round-robin layer replicas) ---------------
    @property
    def replica_count(self) -> int:
        """Size of this node's replica group (1 = unreplicated)."""
        return int(self.meta.get("replica_count") or 1)

    @property
    def replica_index(self) -> Optional[int]:
        """This node's slot in its replica group (None = unreplicated).
        Replica ``i`` of a ``k``-group serves frames with ``f % k == i``."""
        return self.meta.get("replica_index")

    @property
    def replica_group(self) -> Optional[int]:
        """Base-graph node id of this node's replica group, if any."""
        return self.meta.get("replica_group")


class GraphError(ValueError):
    pass


class Graph:
    """A DNN deployment DAG.

    Edges carry the producer's activation bytes (compute-and-forward
    transfers go over shared DRAM / ICI between PUs).
    """

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: Dict[int, Node] = {}
        self._succ: Dict[int, List[int]] = {}
        self._pred: Dict[int, List[int]] = {}
        self._topo_cache: Optional[List[int]] = None
        self._anc_cache: Optional[Dict[int, int]] = None  # id -> bitmask

    # -- construction ----------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.node_id in self.nodes:
            raise GraphError(f"duplicate node id {node.node_id}")
        self.nodes[node.node_id] = node
        self._succ[node.node_id] = []
        self._pred[node.node_id] = []
        self._invalidate()
        return node

    def add(self, name: str, kind: OpKind, *, deps: Sequence[int] = (), **kw) -> Node:
        """Convenience: create node with the next free id and wire deps."""
        nid = (max(self.nodes) + 1) if self.nodes else 1
        node = Node(node_id=nid, name=name, kind=kind, **kw)
        self.add_node(node)
        for d in deps:
            self.add_edge(d, nid)
        return node

    def add_edge(self, src: int, dst: int) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise GraphError(f"edge ({src},{dst}) references unknown node")
        if dst not in self._succ[src]:
            self._succ[src].append(dst)
            self._pred[dst].append(src)
        self._invalidate()

    def _invalidate(self) -> None:
        self._topo_cache = None
        self._anc_cache = None
        # compiled simulation contexts (core.simcontext) are derived from
        # the structure; any mutation makes them stale.  The same goes for
        # the scratch cache (scheduler memos) and the replica-variant seed
        # link: both assume the structure they were derived from.
        self.__dict__.pop("_sim_contexts", None)
        self.__dict__.pop("_scratch", None)
        self.__dict__.pop("_ctx_seed", None)

    def scratch(self) -> dict:
        """Mutation-scoped scratch cache for derived deterministic figures
        (scheduler longest paths, lblp-r probe sessions, ...).  Cleared by
        ``_invalidate`` on any structural mutation; callers key entries by
        content (cost-model profile, fleet signature), never identity."""
        cache = self.__dict__.get("_scratch")
        if cache is None:
            cache = self.__dict__["_scratch"] = {}
        return cache

    # -- queries ----------------------------------------------------------
    def successors(self, nid: int) -> List[int]:
        return list(self._succ[nid])

    def predecessors(self, nid: int) -> List[int]:
        return list(self._pred[nid])

    def edges(self) -> Iterable[Tuple[int, int]]:
        for s, ds in self._succ.items():
            for d in ds:
                yield (s, d)

    def sources(self) -> List[int]:
        return [n for n in self.nodes if not self._pred[n]]

    def sinks(self) -> List[int]:
        return [n for n in self.nodes if not self._succ[n]]

    def __len__(self) -> int:
        return len(self.nodes)

    def num_nodes(self, kind: Optional[OpKind] = None,
                  pu_type: Optional[PUType] = None) -> int:
        out = 0
        for n in self.nodes.values():
            if kind is not None and n.kind != kind:
                continue
            if pu_type is not None and n.pu_type != pu_type:
                continue
            out += 1
        return out

    def total_weight_bytes(self) -> float:
        return sum(n.weight_bytes for n in self.nodes.values())

    # -- algorithms ---------------------------------------------------------
    def topo_order(self) -> List[int]:
        """Kahn topological order (stable: ready set kept sorted by id)."""
        if self._topo_cache is not None:
            return list(self._topo_cache)
        indeg = {n: len(self._pred[n]) for n in self.nodes}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[int] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            inserted = False
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
                    inserted = True
            if inserted:
                ready.sort()
        if len(order) != len(self.nodes):
            raise GraphError("graph has a cycle")
        self._topo_cache = order
        return list(order)

    def longest_path(self, time_of: Callable[[Node], float],
                     within: Optional[Iterable[int]] = None) -> List[int]:
        """Maximum-total-``time_of`` source->sink path (paper Alg. 1 step 1).

        Classic DAG dynamic program over the topological order.  Node
        weights only (edge transfer times are handled by the simulator,
        matching the paper which defines the LP over node execution
        times).  ``within`` restricts the DP to a node subset (per-tenant
        paths on a multi-tenant union); predecessors outside the subset
        are ignored.
        """
        members = None if within is None else set(within)
        best: Dict[int, float] = {}
        back: Dict[int, Optional[int]] = {}
        for nid in self.topo_order():
            if members is not None and nid not in members:
                continue
            t = time_of(self.nodes[nid])
            preds = [p for p in self._pred[nid] if p in best]
            if preds:
                p = max(preds, key=lambda q: best[q])
                best[nid] = best[p] + t
                back[nid] = p
            else:
                best[nid] = t
                back[nid] = None
        if not best:
            raise GraphError("longest_path over an empty node set")
        end = max(best, key=lambda q: best[q])
        path: List[int] = []
        cur: Optional[int] = end
        while cur is not None:
            path.append(cur)
            cur = back[cur]
        return path[::-1]

    def critical_time(self, time_of: Callable[[Node], float]) -> float:
        path = self.longest_path(time_of)
        return sum(time_of(self.nodes[n]) for n in path)

    # ancestor bitsets: parallel-branch tests --------------------------------
    def _ancestors(self) -> Dict[int, int]:
        if self._anc_cache is not None:
            return self._anc_cache
        idx = {nid: i for i, nid in enumerate(sorted(self.nodes))}
        anc: Dict[int, int] = {n: 0 for n in self.nodes}
        for nid in self.topo_order():
            m = 0
            for p in self._pred[nid]:
                m |= anc[p] | (1 << idx[p])
            anc[nid] = m
        self._anc_cache = anc
        self._anc_idx = idx
        return anc

    def is_parallel(self, a: int, b: int) -> bool:
        """True iff neither node is an ancestor of the other (parallel
        branches in the sense of the paper's branch constraint)."""
        if a == b:
            return False
        anc = self._ancestors()
        ia, ib = self._anc_idx[a], self._anc_idx[b]
        return not (anc[b] >> ia) & 1 and not (anc[a] >> ib) & 1

    # -- replication (paper-adjacent: LRMP, arXiv:2312.03146) ----------------
    def copy(self) -> "Graph":
        """Structural copy: fresh ``Node`` objects with independent meta
        dicts, same ids and edges.  Subclasses extend via :meth:`_copy_into`."""
        g = type(self)(self.name)
        self._copy_into(g)
        g._set_ctx_seed(self)
        return g

    def _set_ctx_seed(self, parent: "Graph") -> None:
        """Record the pristine ancestor this graph was derived from by a
        replica-preserving transform (copy / replicate / drop_replica).

        ``core.simcontext`` uses the link to seed a derived graph's
        compiled context from the ancestor's (bottom levels and cost
        tables are provably unchanged under those transforms).  The link
        is dropped by ``_invalidate`` the moment the derived graph is
        mutated further, because any other mutation voids that proof."""
        self.__dict__["_ctx_seed"] = parent.__dict__.get("_ctx_seed", parent)

    def ctx_seed(self) -> Optional["Graph"]:
        return self.__dict__.get("_ctx_seed")

    def _copy_into(self, g: "Graph") -> None:
        # direct dict construction: same nodes, same edge order as the
        # historical add_node/add_edge sequence, without the per-call
        # validation and invalidation (lblp-r derives dozens of variants)
        nodes, succ, pred = g.nodes, g._succ, g._pred
        for nid in sorted(self.nodes):
            n = self.nodes[nid]
            nodes[nid] = Node(
                node_id=n.node_id, name=n.name, kind=n.kind, flops=n.flops,
                weight_bytes=n.weight_bytes, out_bytes=n.out_bytes,
                out_elems=n.out_elems, pu_type=n.pu_type,
                fused_act=n.fused_act, meta=dict(n.meta),
            )
            succ[nid] = list(self._succ[nid])
            pred[nid] = list(self._pred[nid])
        g._invalidate()

    def replicate(self, node_id: int, k: int) -> "Graph":
        """Return a copy where ``node_id`` is cloned into ``k`` round-robin
        replicas (LRMP-style layer replication for bottleneck stages).

        Replica ``i`` executes the frames with ``f % k == i``: the simulator
        splits the frame stream round-robin across the group and merges the
        results at the consumers.  Every replica carries the node's full
        weight footprint (weights are duplicated across crossbars) but only
        ``1/k`` of the per-frame compute, which is what
        ``CostModel.frame_time`` charges.
        """
        g = self.copy()
        g._replicate_in_place(node_id, k)
        g._set_ctx_seed(self)
        return g

    def _replicate_in_place(self, node_id: int, k: int) -> None:
        """The body of :meth:`replicate` minus the copy, so
        :meth:`with_replicas` can apply several replications over one
        copy instead of copying the whole graph per replicated node."""
        if k < 1:
            raise GraphError(f"replica count must be >= 1, got {k}")
        node = self.nodes[node_id]  # unknown id -> KeyError
        if node.is_free():
            raise GraphError(f"cannot replicate structural node {node_id}")
        if node.replica_index is not None:
            raise GraphError(
                f"node {node_id} is already replicated; apply counts to the "
                "base graph instead (Graph.with_replicas)")
        if k == 1:
            return
        node.meta.update(replica_group=node_id, replica_index=0,
                         replica_count=k)
        preds = self.predecessors(node_id)
        succs = self.successors(node_id)
        for i in range(1, k):
            rid = max(self.nodes) + 1
            self.add_node(Node(
                node_id=rid, name=f"{node.name}@r{i}", kind=node.kind,
                flops=node.flops, weight_bytes=node.weight_bytes,
                out_bytes=node.out_bytes, out_elems=node.out_elems,
                pu_type=node.pu_type, fused_act=node.fused_act,
                meta={**dict(node.meta), "replica_group": node_id,
                      "replica_index": i, "replica_count": k},
            ))
            for p in preds:
                self.add_edge(p, rid)
            for s in succs:
                self.add_edge(rid, s)
            self._on_replica_added(node_id, rid)

    def _on_replica_added(self, base_id: int, replica_id: int) -> None:
        """Bookkeeping hook for subclasses (tenant registries etc.)."""

    def with_replicas(self, counts: Dict[int, int]) -> "Graph":
        """Apply several replications at once: ``counts`` maps base node id
        to total replica count (entries of 1 are no-ops).  Always returns a
        copy, so callers can derive variants from one pristine graph."""
        g = self.copy()
        for nid in sorted(counts):
            if counts[nid] > 1:
                g._replicate_in_place(nid, counts[nid])
        g._set_ctx_seed(self)
        return g

    def replica_groups(self) -> Dict[int, List[int]]:
        """Base node id -> sorted member ids, replicated groups only."""
        groups: Dict[int, List[int]] = {}
        for nid, n in self.nodes.items():
            if n.replica_group is not None:
                groups.setdefault(n.replica_group, []).append(nid)
        return {b: sorted(ms) for b, ms in groups.items()}

    def drop_replica(self, node_id: int) -> "Graph":
        """Return a copy with replica ``node_id`` removed from its group.

        Survivors are re-indexed ``0..k-2`` (count ``k-1``); a group reduced
        to one member loses its replica tags entirely.  The elastic tier
        uses this to absorb a failed PU's replicated nodes without a full
        re-schedule.
        """
        node = self.nodes[node_id]
        if node.replica_group is None:
            raise GraphError(f"node {node_id} is not a replica")
        g = self.copy()
        members = [m for m in g.replica_groups()[node.replica_group]
                   if m != node_id]
        g._remove_node(node_id)
        members.sort(key=lambda m: g.nodes[m].meta["replica_index"])
        for i, m in enumerate(members):
            meta = g.nodes[m].meta
            if len(members) == 1:
                for key in ("replica_group", "replica_index", "replica_count"):
                    meta.pop(key, None)
            else:
                meta["replica_index"] = i
                meta["replica_count"] = len(members)
        g._set_ctx_seed(self)
        return g

    def _remove_node(self, nid: int) -> None:
        for p in self._pred[nid]:
            self._succ[p].remove(nid)
        for s in self._succ[nid]:
            self._pred[s].remove(nid)
        del self.nodes[nid], self._succ[nid], self._pred[nid]
        self._invalidate()

    def depth_levels(self) -> Dict[int, int]:
        """ASAP level of every node (hop count, used by RR tie-breaks)."""
        lvl: Dict[int, int] = {}
        for nid in self.topo_order():
            preds = self._pred[nid]
            lvl[nid] = 1 + max((lvl[p] for p in preds), default=-1)
        return lvl

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "nodes": [
                    {
                        "id": n.node_id,
                        "name": n.name,
                        "kind": n.kind.value,
                        "flops": n.flops,
                        "weight_bytes": n.weight_bytes,
                        "out_bytes": n.out_bytes,
                        "out_elems": n.out_elems,
                        "pu_type": n.pu_type.value,
                        "fused_act": n.fused_act,
                        "meta": n.meta,
                    }
                    for n in self.nodes.values()
                ],
                "edges": list(self.edges()),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "Graph":
        raw = json.loads(text)
        g = cls(raw["name"])
        for nd in raw["nodes"]:
            g.add_node(
                Node(
                    node_id=nd["id"],
                    name=nd["name"],
                    kind=OpKind(nd["kind"]),
                    flops=nd["flops"],
                    weight_bytes=nd["weight_bytes"],
                    out_bytes=nd["out_bytes"],
                    out_elems=nd["out_elems"],
                    pu_type=PUType(nd["pu_type"]),
                    fused_act=nd.get("fused_act"),
                    meta=nd.get("meta", {}),
                )
            )
        for s, d in raw["edges"]:
            g.add_edge(s, d)
        return g

    def validate(self) -> None:
        self.topo_order()  # raises on cycle
        for nid, node in self.nodes.items():
            if node.node_id != nid:
                raise GraphError(f"node key {nid} != node_id {node.node_id}")


class MultiTenantGraph(Graph):
    """Tagged disjoint union of per-model deployment graphs.

    Multi-tenant serving: several CNNs are resident on the same PU fleet at
    once, each receiving its own frame stream.  The union is itself a
    ``Graph`` — every scheduler and the simulator consume it unchanged —
    but nodes carry their tenant tag (``node.meta["tenant"]``) and the
    union remembers each tenant's node set, sources and sinks, so
    schedulers can balance *per-tenant* critical paths and the simulator
    can drive *per-tenant* frame streams.

    Node ids of ingested graphs are remapped onto disjoint ranges
    (``_id_map`` keeps tenant-local id -> union id); the constituent
    graphs are never mutated.

    Tenants additionally carry a *weight* (priority, default 1.0): the
    simulator's fair-queueing virtual time divides each tenant's
    per-frame resource charge by its weight, so a weight-2 tenant is
    entitled to twice the fleet share of a weight-1 tenant, and
    ``lblp-mt`` places higher-weight tenants' critical paths first.
    Weights are serving policy, not structure: changing one never
    invalidates compiled simulation contexts or scheduler caches (the
    consumers key their memos by weight content instead).
    """

    def __init__(self, name: str = "multi-tenant") -> None:
        super().__init__(name)
        self.tenants: List[str] = []
        self.tenant_weights: Dict[str, float] = {}
        self._tenant_nodes: Dict[str, List[int]] = {}
        self._id_map: Dict[str, Dict[int, int]] = {}

    # -- construction ----------------------------------------------------
    @classmethod
    def union(cls, graphs: Sequence[Graph],
              names: Optional[Sequence[str]] = None,
              name: str = "multi-tenant") -> "MultiTenantGraph":
        """Build the tagged disjoint union of ``graphs``.

        ``names`` defaults to the constituent graphs' names, deduplicated
        with ``#k`` suffixes so two instances of the same model can be
        co-resident.
        """
        mt = cls(name)
        if names is None:
            names = []
            seen: Dict[str, int] = {}
            for g in graphs:
                k = seen.get(g.name, 0)
                seen[g.name] = k + 1
                names.append(g.name if k == 0 else f"{g.name}#{k}")
        if len(names) != len(graphs):
            raise GraphError("names/graphs length mismatch")
        for g, tenant in zip(graphs, names):
            mt.add_tenant(g, tenant)
        return mt

    def add_tenant(self, g: Graph, tenant: Optional[str] = None) -> str:
        """Ingest one model graph under tag ``tenant`` (default: its name)."""
        tenant = tenant if tenant is not None else g.name
        if tenant in self._tenant_nodes:
            raise GraphError(f"duplicate tenant '{tenant}'")
        if not g.nodes:
            raise GraphError(f"tenant '{tenant}' has an empty graph")
        base = max(self.nodes) if self.nodes else 0
        remap: Dict[int, int] = {}
        for old_id in sorted(g.nodes):
            n = g.nodes[old_id]
            new_id = base + len(remap) + 1
            remap[old_id] = new_id
            self.add_node(Node(
                node_id=new_id,
                name=f"{tenant}/{n.name}",
                kind=n.kind,
                flops=n.flops,
                weight_bytes=n.weight_bytes,
                out_bytes=n.out_bytes,
                out_elems=n.out_elems,
                pu_type=n.pu_type,
                fused_act=n.fused_act,
                meta={**n.meta, "tenant": tenant},
            ))
        for s, d in g.edges():
            self.add_edge(remap[s], remap[d])
        self.tenants.append(tenant)
        self._tenant_nodes[tenant] = sorted(remap.values())
        self._id_map[tenant] = remap
        return tenant

    def remove_tenant(self, tenant: str) -> None:
        """Remove one tenant's component (including any replicas of its
        nodes) from the union in place.  Structural mutation: compiled
        simulation contexts and scratch caches are invalidated exactly
        like any other graph edit."""
        if tenant not in self._tenant_nodes:
            raise GraphError(f"unknown tenant '{tenant}'")
        for nid in list(self._tenant_nodes[tenant]):
            self._remove_node(nid)
        self.tenants.remove(tenant)
        del self._tenant_nodes[tenant]
        del self._id_map[tenant]
        self.tenant_weights.pop(tenant, None)

    # -- tenant weights (serving priority) ---------------------------------
    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Set a tenant's serving weight (relative fleet-share priority).

        Intentionally does *not* invalidate compiled contexts: weights
        are not graph structure.  Consumers (the simulator's run memo,
        ``measured_rate``) key their caches by weight content."""
        if tenant not in self._tenant_nodes:
            raise GraphError(f"unknown tenant '{tenant}'")
        if not weight > 0:
            raise GraphError(f"tenant weight must be > 0, got {weight}")
        if weight == 1.0:
            self.tenant_weights.pop(tenant, None)
        else:
            self.tenant_weights[tenant] = float(weight)

    def tenant_weight(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, 1.0)

    # -- replication bookkeeping -------------------------------------------
    def copy(self) -> "MultiTenantGraph":
        mt: MultiTenantGraph = super().copy()  # type: ignore[assignment]
        mt.tenants = list(self.tenants)
        mt.tenant_weights = dict(self.tenant_weights)
        mt._tenant_nodes = {t: list(ns) for t, ns in self._tenant_nodes.items()}
        mt._id_map = {t: dict(m) for t, m in self._id_map.items()}
        return mt

    def _on_replica_added(self, base_id: int, replica_id: int) -> None:
        tenant = self.nodes[base_id].meta.get("tenant")
        if tenant is not None:
            # replica ids are allocated past max(nodes): append keeps order
            self._tenant_nodes[tenant].append(replica_id)

    def _remove_node(self, nid: int) -> None:
        tenant = self.nodes[nid].meta.get("tenant")
        super()._remove_node(nid)
        if tenant is not None and tenant in self._tenant_nodes:
            self._tenant_nodes[tenant] = [
                n for n in self._tenant_nodes[tenant] if n != nid]
            self._id_map[tenant] = {
                k: v for k, v in self._id_map[tenant].items() if v != nid}

    # -- per-tenant queries ------------------------------------------------
    def tenant_of(self, nid: int) -> str:
        node = self.nodes[nid]  # unknown id -> KeyError, not a tag error
        try:
            return node.meta["tenant"]
        except KeyError:
            raise GraphError(f"node {nid} has no tenant tag") from None

    def tenant_nodes(self, tenant: str) -> List[int]:
        return list(self._tenant_nodes[tenant])

    def tenant_sources(self, tenant: str) -> List[int]:
        return [n for n in self._tenant_nodes[tenant] if not self._pred[n]]

    def tenant_sinks(self, tenant: str) -> List[int]:
        return [n for n in self._tenant_nodes[tenant] if not self._succ[n]]

    def union_id(self, tenant: str, local_id: int) -> int:
        """Union node id of ``local_id`` in the tenant's original graph."""
        return self._id_map[tenant][local_id]

    def tenant_longest_path(self, tenant: str,
                            time_of: Callable[[Node], float]) -> List[int]:
        """Longest path restricted to one tenant's component.

        Components are disjoint, so the DP over the union's topological
        order filtered to the tenant's nodes is exact.
        """
        return self.longest_path(time_of, within=self._tenant_nodes[tenant])

    # -- (de)serialization: tenant structure must survive the round-trip ----
    def to_json(self) -> str:
        # node meta (tenant tags, replica tags, cost hints) is already
        # serialized by the base class
        raw = json.loads(super().to_json())
        raw["tenants"] = list(self.tenants)
        raw["id_map"] = self._id_map
        if self.tenant_weights:
            raw["tenant_weights"] = dict(self.tenant_weights)
        return json.dumps(raw, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "MultiTenantGraph":
        raw = json.loads(text)
        mt = cls(raw["name"])
        for nd in raw["nodes"]:
            mt.add_node(
                Node(
                    node_id=nd["id"],
                    name=nd["name"],
                    kind=OpKind(nd["kind"]),
                    flops=nd["flops"],
                    weight_bytes=nd["weight_bytes"],
                    out_bytes=nd["out_bytes"],
                    out_elems=nd["out_elems"],
                    pu_type=PUType(nd["pu_type"]),
                    fused_act=nd.get("fused_act"),
                    meta=nd.get("meta", {}),
                )
            )
        for s, d in raw["edges"]:
            mt.add_edge(s, d)
        mt.tenants = list(raw["tenants"])
        mt.tenant_weights = dict(raw.get("tenant_weights", {}))
        mt._id_map = {t: {int(k): v for k, v in m.items()}
                      for t, m in raw["id_map"].items()}
        # rebuild from the node tags, not _id_map: replicas added after
        # union-time are tenant members without a tenant-local id
        mt._tenant_nodes = {
            t: sorted(nid for nid, n in mt.nodes.items()
                      if n.meta.get("tenant") == t)
            for t in mt.tenants
        }
        return mt
