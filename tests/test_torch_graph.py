"""The port's graph IR and ResNet deployment graphs against the JAX
package's: identical JSON, node counts and Table I ids."""

import pytest

pytest.importorskip("torch")

from repro.models.cnn import graphs as jgraphs
from repro_torch.core.graph import Graph, GraphError, OpKind, PUType
from repro_torch.models.cnn import graphs, layers

BUILDERS = {"resnet8": (graphs.resnet8_graph, jgraphs.resnet8_graph),
            "resnet18": (graphs.resnet18_graph, jgraphs.resnet18_graph)}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_to_json_equals_reference(name):
    port, ref = BUILDERS[name]
    assert port().to_json() == ref().to_json()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_json_round_trip(name):
    g = BUILDERS[name][0]()
    g2 = Graph.from_json(g.to_json())
    assert g2.to_json() == g.to_json()
    assert g2.topo_order() == g.topo_order()


def test_resnet8_counts():
    g = graphs.resnet8_graph()
    assert len(g) == 14 == len(jgraphs.resnet8_graph())
    assert g.num_nodes(pu_type=PUType.IMC) == 10


def test_resnet18_counts_and_table1_ids():
    g = graphs.resnet18_graph()
    assert len(g) == 30
    assert g.num_nodes(kind=OpKind.CONV) == 20
    assert g.num_nodes(kind=OpKind.MVM) == 1
    imc = {nid for nid, nd in g.nodes.items() if nd.pu_type == PUType.IMC}
    assert imc == set(graphs.TABLE1_IMC_NODE_IDS)
    assert graphs.TABLE1_IMC_NODE_IDS == jgraphs.TABLE1_IMC_NODE_IDS
    assert g.sources() == [1] and g.sinks() == [30]
    assert g.total_weight_bytes() == jgraphs.resnet18_graph().total_weight_bytes()


def test_graph_errors():
    g = Graph("t")
    a = g.add("a", OpKind.CONV)
    b = g.add("b", OpKind.ADD, deps=[a.node_id])
    with pytest.raises(GraphError):
        g.add_edge(a.node_id, 99)
    g.add_edge(b.node_id, a.node_id)
    with pytest.raises(GraphError):
        g.validate()


@pytest.mark.parametrize("h,k,stride,padding,want", [
    (32, 3, 1, "SAME", (1, 1, 1, 1)),
    (32, 3, 2, "SAME", (0, 1, 0, 1)),     # not symmetric: XLA's floor/ceil
    (32, 1, 2, "SAME", (0, 0, 0, 0)),
    (9, 3, 2, "SAME", (1, 1, 1, 1)),
    (12, 5, 1, "SAME", (2, 2, 2, 2)),
    (9, 3, 2, "VALID", (0, 0, 0, 0)),
])
def test_conv_pads(h, k, stride, padding, want):
    assert layers.conv_pads(h, h, k, stride, padding) == want


# ---------------------------------------------------------------------------
# The rest of the IR against the reference: longest paths, levels,
# replication, multi-tenant unions and their JSON
# ---------------------------------------------------------------------------

from helpers import build_random_graph  # noqa: E402
from repro.core import cost as jcost  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.core.graph import MultiTenantGraph  # noqa: E402

RANDOM_SEEDS = range(5)


def graph_pair(name):
    """(port graph, reference graph) of the same network: ResNets from
    each package's own builder, YOLOv8n and random graphs carried across
    as JSON."""
    if name in BUILDERS:
        port, ref = BUILDERS[name]
        return port(), ref()
    ref = (jgraphs.yolov8n_graph() if name == "yolov8n"
           else build_random_graph(16, 0.3, int(name.split("-")[1])))
    return Graph.from_json(ref.to_json()), ref


PAIRS = sorted(BUILDERS) + ["yolov8n"] + [f"rand-{s}" for s in RANDOM_SEEDS]


@pytest.mark.parametrize("name", PAIRS)
@pytest.mark.parametrize("profile", ["IMCE_DEFAULT", "IMCE_FAST_LINK"])
def test_longest_path_and_critical_time(name, profile):
    g, rg = graph_pair(name)
    cm = cost.CostModel(getattr(cost, profile))
    rcm = jcost.CostModel(getattr(jcost, profile))
    assert g.longest_path(cm.time) == rg.longest_path(rcm.time)
    assert g.critical_time(cm.time) == rg.critical_time(rcm.time)
    assert cm.longest_path(g) == rcm.longest_path(rg)
    # restricted to a node subset: every other node of the order
    within = g.topo_order()[::2]
    assert (g.longest_path(cm.time, within=within)
            == rg.longest_path(rcm.time, within=within))


@pytest.mark.parametrize("name", PAIRS)
def test_depth_levels_and_parallel_branches(name):
    g, rg = graph_pair(name)
    assert g.depth_levels() == rg.depth_levels()
    ids = sorted(g.nodes)[:24]
    assert ([g.is_parallel(a, b) for a in ids for b in ids]
            == [rg.is_parallel(a, b) for a in ids for b in ids])


def _replica_ops(g):
    """The same replication sequence on either package's graph; returns
    every derived graph."""
    imc = [nid for nid, n in sorted(g.nodes.items())
           if n.pu_type.value == "imc"][:3]
    r1 = g.replicate(imc[0], 3)
    r2 = g.with_replicas({imc[0]: 2, imc[1]: 1, imc[2]: 4})
    group = r2.replica_groups()[imc[2]]
    r3 = r2.drop_replica(group[1])
    r4 = r3.drop_replica(r3.replica_groups()[imc[0]][0])
    return [r1, r2, r3, r4, g.copy()]


@pytest.mark.parametrize("name", PAIRS)
def test_replication_equals_reference(name):
    g, rg = graph_pair(name)
    for mine, ref in zip(_replica_ops(g), _replica_ops(rg)):
        assert mine.to_json() == ref.to_json()
        assert mine.replica_groups() == ref.replica_groups()
        assert mine.topo_order() == ref.topo_order()
        assert ([(n.replica_count, n.replica_index, n.replica_group)
                 for n in mine.nodes.values()]
                == [(n.replica_count, n.replica_index, n.replica_group)
                    for n in ref.nodes.values()])
        assert type(mine).from_json(mine.to_json()).to_json() == mine.to_json()


def test_replication_errors():
    g = graphs.resnet8_graph()
    free = g.add("in", OpKind.INPUT)
    with pytest.raises(GraphError):
        g.replicate(free.node_id, 2)           # a structural node
    with pytest.raises(GraphError):
        g.replicate(2, 0)
    r = g.replicate(2, 2)
    with pytest.raises(GraphError):
        r.replicate(2, 2)                      # already a replica
    with pytest.raises(GraphError):
        g.drop_replica(2)                      # not a replica


def _tenant_ops(cls, r8, r18, r8b):
    """The same union edits on either package; returns a JSON snapshot
    after each one."""
    mt = cls.union([r8, r18, r8b])
    snaps = [mt.to_json()]
    mt.set_tenant_weight("resnet18_cifar", 2.5)
    snaps.append(mt.to_json())
    mt.remove_tenant("resnet8")
    snaps.append(mt.to_json())
    mt.add_tenant(r8, "late")
    snaps.append(mt.to_json())
    mt.set_tenant_weight("resnet18_cifar", 1.0)
    rep = mt.replicate(mt.union_id("late", 2), 2)
    snaps += [mt.to_json(), rep.to_json(),
              rep.drop_replica(rep.replica_groups()[mt.union_id("late", 2)][0])
              .to_json()]
    snaps.append([(t, mt.tenant_weight(t), mt.tenant_nodes(t),
                   mt.tenant_sources(t), mt.tenant_sinks(t))
                  for t in mt.tenants])
    snaps.append([(t, rep.tenant_nodes(t)) for t in rep.tenants])
    return snaps


def test_multi_tenant_graph_equals_reference():
    mine = _tenant_ops(MultiTenantGraph, graphs.resnet8_graph(),
                       graphs.resnet18_graph(), graphs.resnet8_graph())
    ref = _tenant_ops(jgraph.MultiTenantGraph, jgraphs.resnet8_graph(),
                      jgraphs.resnet18_graph(), jgraphs.resnet8_graph())
    assert mine == ref
    assert "resnet8#1" in mine[0]


def test_multi_tenant_longest_path_and_round_trip():
    mt = MultiTenantGraph.union([graphs.resnet8_graph(), graphs.resnet18_graph()])
    rmt = jgraph.MultiTenantGraph.union([jgraphs.resnet8_graph(),
                                         jgraphs.resnet18_graph()])
    cm, rcm = cost.CostModel(), jcost.CostModel()
    for t in mt.tenants:
        assert mt.tenant_longest_path(t, cm.time) == rmt.tenant_longest_path(
            t, rcm.time)
        assert [mt.tenant_of(n) for n in mt.tenant_nodes(t)] == [t] * len(
            mt.tenant_nodes(t))
    back = MultiTenantGraph.from_json(rmt.to_json())
    assert back.to_json() == rmt.to_json()
    assert back.tenants == rmt.tenants
    with pytest.raises(GraphError):
        mt.add_tenant(graphs.resnet8_graph())       # duplicate tenant
    with pytest.raises(GraphError):
        mt.set_tenant_weight("resnet8", 0.0)
    with pytest.raises(GraphError):
        mt.remove_tenant("nope")


def test_mutation_drops_derived_caches():
    g = graphs.resnet8_graph()
    g.scratch()["k"] = 1
    g._ancestors()
    r = g.replicate(2, 2)
    assert r.ctx_seed() is g
    r.add_edge(1, 13)
    assert r.ctx_seed() is None and "k" not in g.copy().scratch()
    g.add_edge(1, 13)
    assert g.scratch() == {} and g._anc_cache is None
