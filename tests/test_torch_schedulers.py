"""The port's schedulers against the reference's: the same registry, and
for every scheduler the same ``{node_id: pu_id}`` mapping, fleet and
``meta`` on the paper's fleets and on random graphs, equal with ``==``."""

import dataclasses
import enum

import pytest

pytest.importorskip("torch")

from helpers import build_random_graph
from repro.core import cost as jcost
from repro.core import graph as jgraph
from repro.core import schedulers as jsched
from repro.models.cnn import graphs as jgraphs
from repro_torch.core import cost, schedulers
from repro_torch.core.graph import Graph, MultiTenantGraph
from repro_torch.core.schedulers import ScheduleError
from repro_torch.models.cnn import graphs

ROOMY = dict(name="roomy", pu_weight_capacity=1e12)
RESNET8_FLEETS = [(2, 1), (4, 2), (7, 3), (10, 4)]
HEURISTICS = [a for a in jsched.available() if a != "optimal"]


def plain(x):
    """A value of either package as plain data: enums by value, graphs by
    their JSON, dataclasses field by field."""
    if isinstance(x, enum.Enum):
        return ("enum", x.value)
    if isinstance(x, (Graph, jgraph.Graph)):
        return ("graph", x.to_json())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def assert_same_assignment(a, ra):
    assert a.mapping == ra.mapping
    assert list(a.mapping) == list(ra.mapping)
    assert [(p.pu_id, p.pu_type.value, p.speed, p.weight_capacity)
            for p in a.pus] == [(p.pu_id, p.pu_type.value, p.speed,
                                 p.weight_capacity) for p in ra.pus]
    assert a.algorithm == ra.algorithm
    assert plain(a.meta) == plain(ra.meta)


def schedule_both(alg, g, rg, fleet, profile=None, **kw):
    cm = cost.CostModel(cost.HardwareProfile(**profile)) if profile \
        else cost.CostModel()
    rcm = jcost.CostModel(jcost.HardwareProfile(**profile)) if profile \
        else jcost.CostModel()
    a = schedulers.get_scheduler(alg, cm, **kw).schedule(
        g, cost.make_pus(*fleet, cm.profile))
    ra = jsched.get_scheduler(alg, rcm, **kw).schedule(
        rg, jcost.make_pus(*fleet, rcm.profile))
    assert_same_assignment(a, ra)
    assert a.load(g, cm) == ra.load(rg, rcm)
    assert a.weights(g) == ra.weights(rg)
    assert a.bottleneck(g, cm) == ra.bottleneck(rg, rcm)
    return a, ra


def test_registry_equals_reference():
    assert schedulers.available() == jsched.available()
    assert "optimal" in schedulers.available()
    with pytest.raises(KeyError):
        schedulers.get_scheduler("nope")


@pytest.mark.parametrize("fleet", RESNET8_FLEETS, ids=str)
@pytest.mark.parametrize("alg", HEURISTICS)
def test_resnet8_equals_reference(alg, fleet):
    schedule_both(alg, graphs.resnet8_graph(), jgraphs.resnet8_graph(), fleet)


@pytest.mark.parametrize("alg", HEURISTICS)
def test_resnet18_table1_equals_reference(alg):
    schedule_both(alg, graphs.resnet18_graph(), jgraphs.resnet18_graph(),
                  (8, 4))


@pytest.mark.parametrize("alg", [a for a in HEURISTICS if a != "lblp-x"])
def test_yolov8n_equals_reference(alg):
    rg = jgraphs.yolov8n_graph()
    schedule_both(alg, Graph.from_json(rg.to_json()), rg, (8, 4))


@pytest.mark.parametrize("seed", range(20))
def test_random_graphs_equal_reference(seed):
    rg = build_random_graph(12, 0.3, seed)
    g = Graph.from_json(rg.to_json())
    for alg in HEURISTICS:
        schedule_both(alg, g, rg, (3, 2), ROOMY)
    # optimal where the reference's own tests run it: 12 nodes, 3+2 PUs
    schedule_both("optimal", g, rg, (3, 2), ROOMY)
    schedule_both("lblp", g, rg, (3, 2), ROOMY, branch_constraint=False)


def test_optimal_refuses_large_graphs_like_reference():
    rg = build_random_graph(40, 0.2, 1)
    g = Graph.from_json(rg.to_json())
    cm = cost.CostModel(cost.HardwareProfile(**ROOMY))
    with pytest.raises(ValueError, match="limited to 26 nodes"):
        schedulers.get_scheduler("optimal", cm).schedule(g, cost.make_pus(2, 1))


def test_capacity_spills_equal_reference():
    # the reference's own case: a tight profile forces capacity waivers
    prof = dict(pu_weight_capacity=700e3)
    for alg in ("lblp", "wb", "lblp-x"):
        schedule_both(alg, graphs.resnet18_graph(), jgraphs.resnet18_graph(),
                      (2, 1), prof)


@pytest.mark.parametrize("fleet", [(8, 4), (4, 2), (12, 6)], ids=str)
def test_lblp_mt_and_replication_equal_reference(fleet):
    mt = MultiTenantGraph.union([graphs.resnet8_graph(), graphs.resnet18_graph()])
    rmt = jgraph.MultiTenantGraph.union([jgraphs.resnet8_graph(),
                                         jgraphs.resnet18_graph()])
    mt.set_tenant_weight("resnet8", 2.0)
    rmt.set_tenant_weight("resnet8", 2.0)
    for alg in ("lblp-mt", "lblp-r"):
        a, ra = schedule_both(alg, mt, rmt, fleet)
        assert a.tenant_load(mt, cost.CostModel()) == ra.tenant_load(
            rmt, jcost.CostModel())
    # lblp-r with rate validation, and the pair schedule_replicated returns
    schedule_both("lblp-r", mt, rmt, fleet, validate_rate=32,
                  sim_engine="periodic")
    g_r, a = schedulers.schedule_replicated(graphs.resnet8_graph(),
                                            cost.make_pus(*fleet))
    rg_r, ra = jsched.schedule_replicated(jgraphs.resnet8_graph(),
                                          jcost.make_pus(*fleet))
    assert g_r.to_json() == rg_r.to_json()
    assert_same_assignment(a, ra)


def test_lblp_r_refuses_a_replicated_graph():
    g = graphs.resnet8_graph().replicate(2, 2)
    with pytest.raises(ScheduleError):
        schedulers.get_scheduler("lblp-r").schedule(g, cost.make_pus(4, 2))


def test_replication_candidates_equal_reference():
    from repro.core.schedulers import lblp_r as jlblp_r
    from repro_torch.core.schedulers import lblp_r
    g, rg = graphs.resnet18_graph(), jgraphs.resnet18_graph()
    a, ra = schedule_both("lblp", g, rg, (8, 4))
    cm, rcm = cost.CostModel(), jcost.CostModel()
    mine = lblp_r.replication_candidates(g, a, a.load(g, cm), cm,
                                         cost.make_pus(8, 4), {})
    ref = jlblp_r.replication_candidates(rg, ra, ra.load(rg, rcm), rcm,
                                         jcost.make_pus(8, 4), {})
    assert mine == ref
    sess = lblp_r.ProbeSession.for_graph(
        g, cm, cost.make_pus(8, 4), schedulers.get_scheduler("lblp", cm))
    rsess = jlblp_r.ProbeSession.for_graph(
        rg, rcm, jcost.make_pus(8, 4), jsched.get_scheduler("lblp", rcm))
    for counts in ({}, {2: 2}, {2: 2, 7: 3}):
        e, re_ = sess.probe(counts), rsess.probe(counts)
        assert plain(e["vec"]) == plain(re_["vec"])
        assert e["load"] == re_["load"]
        assert_same_assignment(e["assignment"], re_["assignment"])
    # the session lives in the graph's scratch cache: the same object
    # comes back until the graph is mutated
    assert lblp_r.ProbeSession.for_graph(
        g, cm, cost.make_pus(8, 4), schedulers.get_scheduler("lblp", cm)) is sess
